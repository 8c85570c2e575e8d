"""Hand-written Hopper kernels of the stencil hot path, plus their oracles.

`ops` is the public entry point. `stencil_mwd` (K1, ``csrc/mwd.cu``),
`stencil_sweep` (K2, ``csrc/sweep.cu``) and `stencil_fused` (K3,
``csrc/fused.cu``) each hold a kernel's host side, its plain PyTorch
version and the wrapper that launches it; the three sources share
``csrc/stencil_cell.cuh``. `_build` compiles and binds the CUDA sources,
`_host` holds the launchers' shared conventions, and `ref` the naive
oracles every kernel is checked against.
"""
