from .ring_gemm import (ag_matmul, gather_contract, matmul_rs, ring_ag_gemm,
                        ring_ag_gemm_reference, ring_gc_gemm_acc,
                        ring_gc_gemm_acc_reference, ring_rs_gemm_add,
                        ring_rs_gemm_add_reference)
