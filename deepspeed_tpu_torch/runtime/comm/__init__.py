from .compressed import CompressedBackend
from .onebit import (compressed_allreduce_local, masked_compress,
                     onebit_all_gather_local, onebit_padded_size,
                     onebit_reduce_scatter_local)
from .quantize import (DEFAULT_BLOCK_SIZE, WIRE, FusedFlatLayout,
                       QuantizedCollectives, dequantize_blockwise,
                       hierarchical_all_reduce_local, pack_signs,
                       qc_padded_size, quantize_blockwise,
                       quantize_dequantize, quantize_with_error_feedback,
                       quantized_all_gather_local,
                       quantized_all_reduce_local,
                       ring_reduce_scatter_inline, sign_scale,
                       unpack_signs)
