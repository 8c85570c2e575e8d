"""PyTorch/CUDA port of the MWD stencil system.

The JAX package `repro` is the reference; this package keeps its module
names (`core.ir`, `core.tiling`, `kernels.ops`, `launch.serve`, ...) so each
counterpart is easy to find, and imports nothing of it. Tensors are plain
`torch.Tensor`s on an explicit device: entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and they raise instead of falling back
when no GPU is present. The hand-written Hopper kernels (the MWD advance and
the spatial and ghost-zone baselines, under `kernels`) build with ``nvcc``
at first use.
"""
