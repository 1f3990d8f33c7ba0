"""Kernels of the port: each Pallas kernel of `paddle_tpu/ops/` becomes a
hand-written Hopper kernel (`csrc/*.cu`) with a plain PyTorch version
and a launch counter beside it, in a module of its own
(`ops.paged_attention`: K4; `ops.flash_attention`: K1, K2;
`ops.softmax_xent`: K3; `ops.gmm`: K5).  `_build` compiles and loads
them; `ops.moe_ops` routes MoE tokens to K5."""
