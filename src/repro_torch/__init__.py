"""PyTorch/CUDA port of the MWD stencil system.

The JAX package `repro` is the reference; this package keeps its module
names (`core.ir`, `core.tiling`, `kernels.ops`, `launch.serve`, ...) so each
counterpart is easy to find, and imports nothing of it. Tensors are plain
`torch.Tensor`s on an explicit device: entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and they raise instead of falling back
when no GPU is present. The one hand-written Hopper kernel (the MWD advance,
`kernels.stencil_mwd`) builds with ``nvcc`` at first use.
"""
