"""Multi-GPU support: process groups, work slicing and the ZeRO-1 shard
choice (port of align3r_tpu/parallel/)."""
