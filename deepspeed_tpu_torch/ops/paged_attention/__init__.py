from .paged_attention import (paged_attention, paged_attention_reference,
                              build)
