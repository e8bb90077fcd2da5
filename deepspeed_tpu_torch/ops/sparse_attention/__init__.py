"""Block-sparse attention (port of deepspeed_tpu/ops/sparse_attention;
reference deepspeed/ops/sparse_attention/__init__.py)."""
from .sparsity_config import (SparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, VariableSparsityConfig,
                              BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              SlidingWindowSparsityConfig,
                              causal_sliding_window_layout)
from .block_sparse_attention import (make_block_sparse_attention,
                                     build_block_index)
from .sparse_self_attention import SparseSelfAttention, BertSparseSelfAttention
from .sparse_attention_utils import SparseAttentionUtils
from .sparsity_config import sparsity_config_from_dict
