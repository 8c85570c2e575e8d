"""The distributed stencil stepper, on one controller or one rank per
mesh row.

`stepper` (the deep-halo super-steps, plain or K1 per shard, synchronous
or overlapped), `halo` (the exchange, on communication streams on CUDA;
across processes through a `Carrier`), `process` (the process group:
`initialize`, `ProcessDevice`, ranks spawned under a deadline),
`compression` (int8 halos and gradients with error feedback),
`checkpoint` (the reference's on-disk layout) and `elastic` (rescale onto
another mesh, single-controller). Meshes come from
`repro_torch.launch.mesh`.
"""
