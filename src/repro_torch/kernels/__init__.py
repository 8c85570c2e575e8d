"""Hand-written Hopper kernels of the stencil hot path, plus their oracles.

`ops` is the public entry point; `stencil_mwd` holds the MWD kernel's host
side, its plain PyTorch version and the wrapper that launches
``csrc/mwd.cu``; `_build` compiles and binds the CUDA sources; `ref` holds
the naive oracles every kernel is checked against.
"""
