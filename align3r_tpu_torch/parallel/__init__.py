"""Multi-GPU support: process groups and the data x model mesh, work
slicing, the ZeRO-1 shard choice and the tensor-parallel split of the
network (port of align3r_tpu/parallel/)."""
