from .int8 import dequantize_kv, quantize_kv_rows

__all__ = ["quantize_kv_rows", "dequantize_kv"]
