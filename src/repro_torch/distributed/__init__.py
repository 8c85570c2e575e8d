"""The distributed stencil stepper: one process holding every shard.

`stepper` (the deep-halo super-steps, plain or K1 per shard, synchronous
or overlapped), `halo` (the exchange, on communication streams on CUDA),
`compression` (int8 halos and gradients with error feedback),
`checkpoint` (the reference's on-disk layout) and `elastic` (rescale onto
another mesh). Meshes come from `repro_torch.launch.mesh`.
"""
