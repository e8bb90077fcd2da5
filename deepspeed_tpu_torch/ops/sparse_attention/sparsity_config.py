"""Block-sparse attention layout generators.

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept
as the port's own copy (the original imports only numpy, but its
package's ``__init__`` imports JAX). The same classes, the same
``(num_heads, num_blocks, num_blocks)`` 0/1 layouts, and the same random
blocks for the same seed: variable and bigbird draw from
``np.random.RandomState(seed)`` in the original's order. The layout is
host metadata: ``block_sparse_attention.py`` turns it into the row tables
its CUDA kernels walk.

Patterns (all public designs): Fixed = Sparse Transformers
(arXiv:1904.10509); BigBird = arXiv:2007.14062 (ITC flavor);
BSLongformer = block-sparse Longformer (arXiv:2004.05150).
"""
import numpy as np

UNIDIRECTIONAL = "unidirectional"
BIDIRECTIONAL = "bidirectional"


def sparsity_config_from_dict(config, num_heads):
    """Build the matching SparsityConfig from a parsed ``sparse_attention``
    config dict (runtime/config.py get_sparse_attention, reference
    runtime/config.py:143-350)."""
    cfg = dict(config)
    mode = cfg.pop("mode", "fixed")
    classes = {"dense": DenseSparsityConfig, "fixed": FixedSparsityConfig,
               "variable": VariableSparsityConfig,
               "bigbird": BigBirdSparsityConfig,
               "bslongformer": BSLongformerSparsityConfig,
               "sliding_window": SlidingWindowSparsityConfig}
    if mode not in classes:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!")
    cfg = {k: v for k, v in cfg.items() if v is not None}
    return classes[mode](num_heads=num_heads, **cfg)


class SparsityConfig:
    """Shared properties of block-sparse layouts.

    ``make_layout(seq_len)`` returns an int64 array of shape
    ``(num_heads, seq_len // block, seq_len // block)`` where entry
    ``[h, qi, ki]`` is 1 iff query block ``qi`` of head ``h`` attends to
    key block ``ki``.
    """

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size "
                f"{self.block}!")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        """When all heads share one layout, head 0 is authoritative."""
        if not self.different_layout_per_head:
            layout[1:] = layout[:1]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError

    # -- vectorized building blocks shared by the subclasses ---------------

    @staticmethod
    def _window_mask(num_blocks, boundaries, unidirectional):
        """Dense-within-window mask: ``boundaries`` is an int array mapping
        each block row to its window id; rows attend to every block of their
        own window (lower-triangular part only if unidirectional)."""
        same = boundaries[:, None] == boundaries[None, :]
        if unidirectional:
            rows = np.arange(num_blocks)
            same &= rows[:, None] >= rows[None, :]
        return same

    @staticmethod
    def _global_cols(num_blocks, cols, unidirectional, horizontal, mask):
        """Mark global column stripes (and horizontal rows if requested).
        Unidirectional heads only look at a global column from rows at or
        below it (no peeking forward)."""
        rows = np.arange(num_blocks)
        for c0, c1 in cols:
            c1 = min(c1, num_blocks)
            if c0 >= num_blocks:
                continue
            stripe = np.zeros((num_blocks, num_blocks), dtype=bool)
            first_row = c0 if unidirectional else 0
            stripe[rows >= first_row, c0:c1] = True
            mask |= stripe
            if horizontal:
                mask[c0:c1, :] = True
        return mask


class DenseSparsityConfig(SparsityConfig):
    """Degenerate all-ones layout — lets dense attention flow through the
    sparse kernel path (reference sparsity_config.py:63)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks
    (reference sparsity_config.py:94, after arXiv:1904.10509)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention=BIDIRECTIONAL, horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of local blocks ({num_local_blocks}) must be "
                f"divisible by number of global blocks "
                f"({num_global_blocks})!")
        if attention not in (UNIDIRECTIONAL, BIDIRECTIONAL):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != BIDIRECTIONAL and horizontal_global_attention:
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns require "
                             "different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"({num_different_global_patterns}) cannot exceed "
                f"{num_local_blocks // num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _head_mask(self, h, num_blocks):
        uni = self.attention == UNIDIRECTIONAL
        windows = np.arange(num_blocks) // self.num_local_blocks
        mask = self._window_mask(num_blocks, windows, uni)

        # Global stripes: in each full local window the representative is
        # the block group `num_global_blocks` wide, counted back from the
        # window end; heads rotate through the available positions.
        g = self.num_global_blocks
        offset = (self.num_local_blocks -
                  (1 + h % self.num_different_global_patterns) * g)
        full_end = num_blocks - num_blocks % self.num_local_blocks
        cols = [(c, c + g)
                for c in range(offset, full_end, self.num_local_blocks)]
        if full_end < num_blocks:  # ragged trailing window
            start = min(full_end + offset, num_blocks - g)
            cols.append((start, start + g))
        return self._global_cols(num_blocks, cols, uni,
                                 self.horizontal_global_attention, mask)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            layout[h][self._head_mask(h, num_blocks)] = 1
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable-width local windows + explicit global indices + random
    blocks (reference sparsity_config.py:243)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention=BIDIRECTIONAL, horizontal_global_attention=False,
                 seed=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global block start/end index lists must have equal "
                    "length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in (UNIDIRECTIONAL, BIDIRECTIONAL):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != BIDIRECTIONAL and horizontal_global_attention:
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.RandomState(seed)

    def _random_mask(self, num_blocks):
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks ({self.num_random_blocks}) must "
                f"not exceed blocks per row ({num_blocks})!")
        mask = np.zeros((num_blocks, num_blocks), dtype=bool)
        for row in range(num_blocks):
            cols = self._rng.choice(num_blocks, self.num_random_blocks,
                                    replace=False)
            mask[row, cols] = True
        return mask

    def _head_mask(self, num_blocks):
        uni = self.attention == UNIDIRECTIONAL
        # Window id per block row: listed widths first, the last width
        # repeats over the remainder of the sequence.
        widths = list(self.local_window_blocks)
        bounds = np.empty(num_blocks, dtype=np.int64)
        pos, win = 0, 0
        for w in widths:
            if pos >= num_blocks:
                break
            bounds[pos:pos + w] = win
            pos += w
            win += 1
        last = widths[-1]
        while pos < num_blocks:
            bounds[pos:pos + last] = win
            pos += last
            win += 1
        mask = self._window_mask(num_blocks, bounds, uni)

        if self.num_random_blocks > 0:
            mask |= self._random_mask(num_blocks)

        if self.global_block_end_indices is None:
            cols = [(i, i + 1) for i in self.global_block_indices]
        else:
            cols = list(zip(self.global_block_indices,
                            self.global_block_end_indices))
        return self._global_cols(num_blocks, cols, uni,
                                 self.horizontal_global_attention, mask)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            layout[h][self._head_mask(num_blocks)] = 1
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + leading-global blocks, ITC flavor
    (reference sparsity_config.py:421, after arXiv:2007.14062)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, seed=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self._rng = np.random.RandomState(seed)

    def _head_mask(self, num_blocks):
        for name, need in (("random", self.num_random_blocks),
                           ("sliding window", self.num_sliding_window_blocks),
                           ("global", self.num_global_blocks)):
            if num_blocks < need:
                raise ValueError(
                    f"Number of {name} blocks ({need}) must not exceed "
                    f"blocks per row ({num_blocks})!")
        rows = np.arange(num_blocks)
        w = self.num_sliding_window_blocks // 2
        mask = np.abs(rows[:, None] - rows[None, :]) <= w
        g = self.num_global_blocks
        mask[:g, :] = True
        mask[:, :g] = True
        for row in range(num_blocks):
            cols = self._rng.choice(num_blocks, self.num_random_blocks,
                                    replace=False)
            mask[row, cols] = True
        return mask

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            layout[h][self._head_mask(num_blocks)] = 1
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + symmetric global rows/cols at chosen indices —
    block-sparse Longformer (reference sparsity_config.py:544)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global block start/end index lists must have equal "
                    "length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices

    def _head_mask(self, num_blocks):
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"Number of sliding window blocks "
                f"({self.num_sliding_window_blocks}) must not exceed blocks "
                f"per row ({num_blocks})!")
        rows = np.arange(num_blocks)
        w = self.num_sliding_window_blocks // 2
        mask = np.abs(rows[:, None] - rows[None, :]) <= w
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for s, e in spans:
            if s >= num_blocks:
                continue
            e = min(e, num_blocks)
            mask[s:e, :] = True
            mask[:, s:e] = True
        return mask

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            layout[h][self._head_mask(num_blocks)] = 1
        return self.check_and_propagate_first_head_layout(layout)


class SlidingWindowSparsityConfig(SparsityConfig):
    """Pure causal sliding window — the JAX package's extension layout
    (``causal_sliding_window_layout``) as a first-class, ds_config-reachable
    SparsityConfig: ``{"sparse_attention": {"mode": "sliding_window", ...}}``.

    Every query block attends its previous ``num_sliding_window_blocks``
    blocks (itself included), so active blocks per row are CONSTANT and
    attention cost is linear in sequence length; the reference modes'
    global rows/columns grow per-row work with position. The layout is
    causal by construction, so
    :class:`SparseSelfAttention` forces intra-block causal masking for it
    (``requires_causal``).
    """

    requires_causal = True

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_sliding_window_blocks < 1:
            raise ValueError(
                f"num_sliding_window_blocks "
                f"({num_sliding_window_blocks}) must be >= 1")
        self.num_sliding_window_blocks = num_sliding_window_blocks

    def make_layout(self, seq_len):
        self.setup_layout(seq_len)  # validates divisibility
        num_blocks = seq_len // self.block
        return causal_sliding_window_layout(
            self.num_heads, num_blocks,
            min(self.num_sliding_window_blocks, num_blocks))


def causal_sliding_window_layout(num_heads, num_blocks, window_blocks):
    """The JAX package's extension (not in the reference surface): pure
    causal sliding-window layout — each row attends its previous
    ``window_blocks`` blocks only, so active blocks per row are CONSTANT
    and attention cost is linear in sequence length; the reference's
    `fixed`/`bslongformer` modes add global rows/columns whose active
    count grows with position. Reference analogue:
    BSLongformerSparsityConfig with no global blocks, trimmed causally.
    """
    if window_blocks < 1:
        raise ValueError(
            f"window_blocks ({window_blocks}) must be >= 1")
    if num_blocks < 1:
        raise ValueError(f"num_blocks ({num_blocks}) must be >= 1")
    rows = np.arange(num_blocks)
    mask = (rows[:, None] - rows[None, :] >= 0) & \
           (rows[:, None] - rows[None, :] < window_blocks)
    return np.repeat(mask[None].astype(np.int64), num_heads, axis=0)
