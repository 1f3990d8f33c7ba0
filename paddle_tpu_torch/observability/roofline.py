"""Device roofline tables (public specs) for `chip_smoke.py`'s kernel
bounds.

`peak_*` take the card's marketing name (`torch.cuda.get_device_name()`)
and match lowercase substrings, longest key first ("h100 pcie" before
"h100").  A card that is not in the tables raises: a bound taken from
some other card's rates would misstate how far a kernel is from it.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_FP32_FLOPS", "PEAK_TF32_FLOPS",
           "PEAK_INT8_OPS", "PEAK_HBM_BW",
           "PEAK_HOST_LINK_BW", "peak_flops", "peak_hbm_bw",
           "peak_host_link_bw"]

# dense bf16 tensor-core FLOP/s per card (NVIDIA data sheets)
PEAK_FLOPS = {
    "h100": 989e12,          # H100 SXM5 (name "NVIDIA H100 80GB HBM3")
    "h100 pcie": 756e12,
}

# fp32 FLOP/s outside the tensor cores (NVIDIA data sheets): the rate
# of kernels that compute in fp32 on the CUDA cores
PEAK_FP32_FLOPS = {
    "h100": 67e12,
    "h100 pcie": 51e12,
}

# dense TF32 tensor-core FLOP/s per card (NVIDIA data sheets).  An
# fp32-accurate product taken as three TF32 products (dtype
# "float32_3xtf32": x = big + small, big.small + small.big + big.big)
# runs at a third of it, the fastest way to fp32-accurate products on
# the card
PEAK_TF32_FLOPS = {
    "h100": 495e12,
    "h100 pcie": 378e12,
}

# dense int8 tensor-core OP/s per card (NVIDIA data sheets): the rate
# of int8 x int8 products accumulated in int32
PEAK_INT8_OPS = {
    "h100": 1979e12,
    "h100 pcie": 1513e12,
}

# device-memory bandwidth per card (NVIDIA data sheets): the decode
# step is bandwidth-bound (reads all params + the KV pool per token),
# so its roofline is bytes/s, not FLOP/s
PEAK_HBM_BW = {
    "h100": 3.35e12,
    "h100 pcie": 2.0e12,
}

# host link per card, one direction (NVIDIA data sheets: PCIe Gen5 x16,
# 128 GB/s both ways): the rate of a kernel that reads pinned host
# memory in place
PEAK_HOST_LINK_BW = {
    "h100": 64e9,
    "h100 pcie": 64e9,
}


def _peak_lookup(table, kind) -> float:
    name = str(kind).lower()
    for key in sorted(table, key=len, reverse=True):
        if key in name:
            return table[key]
    raise KeyError(f"no peak rates for card {kind!r}; known: "
                   f"{sorted(table)}")


def peak_flops(kind, dtype="bfloat16") -> float:
    """Peak FLOP/s of card `kind` for work in `dtype` ("bfloat16" on
    the tensor cores, "float32" on the CUDA cores, "float32_3xtf32" as
    three TF32 tensor-core products, "int8" int8 products into int32
    on the tensor cores; "float16" is bf16's rate)."""
    if str(dtype) == "float32_3xtf32":
        return _peak_lookup(PEAK_TF32_FLOPS, kind) / 3
    if str(dtype) in ("int8", "torch.int8"):
        return _peak_lookup(PEAK_INT8_OPS, kind)
    table = PEAK_FP32_FLOPS if str(dtype) in ("float32", "torch.float32") \
        else PEAK_FLOPS
    return _peak_lookup(table, kind)


def peak_hbm_bw(kind) -> float:
    return _peak_lookup(PEAK_HBM_BW, kind)


def peak_host_link_bw(kind) -> float:
    return _peak_lookup(PEAK_HOST_LINK_BW, kind)
