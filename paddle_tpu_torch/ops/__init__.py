"""Kernels of the port: each Pallas kernel of `paddle_tpu/ops/` becomes a
hand-written Hopper kernel (`csrc/*.cu`) with a plain PyTorch version
and a launch counter beside it, in a module of its own
(`ops.paged_attention`: kernel K4).  `_build` compiles and loads them."""
