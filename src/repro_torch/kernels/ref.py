"""Plain-torch oracles for the port's kernels.

Every stencil kernel's oracle is the naive sweep sequence from
`repro_torch.core.stencils`: kernels differ only in memory choreography.
"""

from __future__ import annotations

from repro_torch.core import stencils as st


def naive_steps(spec: st.StencilSpec, state, coeffs, n_steps: int):
    """Advance (cur, prev) by n_steps sequential full-grid sweeps."""
    return st.run_naive(spec, state, coeffs, n_steps)


def single_sweep(spec: st.StencilSpec, state, coeffs):
    """One time step with pointer swap: the single-sweep kernels' oracle."""
    return st.step(spec, state, coeffs)
