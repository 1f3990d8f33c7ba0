from .int8 import (dequantize_kv, matmul_wo_int8, quantize_kv_rows,
                   quantize_weight, weight_only_int8)

__all__ = ["quantize_weight", "weight_only_int8", "matmul_wo_int8",
           "quantize_kv_rows", "dequantize_kv"]
