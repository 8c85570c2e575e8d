// K2 on Hopper: one time step of the IR-generated sweep, spatially blocked
// (the paper's "optimal spatial blocking" baseline), written by hand in
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_sweep.py::_kernel
// (Pallas grid over z-slabs, each program copying a (bz+2R)-row window of
// every edge-padded stream into VMEM and emitting bz rows). Here:
//   * one launch per time step; the host loops the steps on one stream;
//   * block (i, j) owns the z-rows [i*bz, (i+1)*bz) of the y-range
//     [j*SWEEP_BY, (j+1)*SWEEP_BY) and walks x with its threads, so
//     neighbouring threads touch neighbouring addresses;
//   * every cell of `out` is written: frame cells are copied from cur and
//     interior cells computed, so the host makes no clone of the grid. The
//     reference pads only to give its DMA windows a fixed shape; no interior
//     cell reads beyond the grid, so no padded copy exists here.
//   * out of place: cur, prev and the coefficients are only read.
//
// What bounds it on this card: bytes. One step reads each input stream once
// and writes one grid, (N_D + 1) words per update; the 7-37 flops per update
// sit far below the H100's ~20 flop/byte ridge. Tap reuse between
// neighbouring rows is left to L1/L2.
//
// Arithmetic: `update_cell` of stencil_cell.cuh in the stream type, as the
// reference has no accumulator option. Built with -fmad=false, so it agrees
// bit for bit with the plain PyTorch version (repro_torch.core.ir).

#include "stencil_cell.cuh"

#define SWEEP_THREADS 256
#define SWEEP_BY 4

struct SweepGeo {
  long long grid_elems;   // elements of one grid (nz*ny*nx)
  long long sz, sy;       // z and y strides (x is contiguous)
  int nz, ny, nx, bz, radius;
};

template <typename S>
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_kernel(S* out, const S* cur, const S* prev, const S* coeff,
             __grid_constant__ const SweepGeo g,
             __grid_constant__ const Op op) {
  const int R = g.radius;
  const int z0 = blockIdx.x * g.bz, z1 = min(z0 + g.bz, g.nz);
  const int y0 = blockIdx.y * SWEEP_BY, y1 = min(y0 + SWEEP_BY, g.ny);
  for (int z = z0; z < z1; ++z) {
    for (int y = y0; y < y1; ++y) {
      const bool frame_row = z < R || z >= g.nz - R || y < R
          || y >= g.ny - R;
      const long long row = (long long)z * g.sz + (long long)y * g.sy;
      for (int x = threadIdx.x; x < g.nx; x += blockDim.x) {
        const long long off = row + x;
        if (frame_row || x < R || x >= g.nx - R)
          out[off] = cur[off];
        else
          update_cell<S, S>(cur + off, op.tap_off, prev + off, out + off,
                            coeff, off, g.grid_elems, op);
      }
    }
  }
}

template <typename S>
static int launch_step(void* out, const void* cur, const void* prev,
                       const void* coeff, const SweepGeo& g, const Op& op,
                       cudaStream_t stream) {
  const dim3 grid((g.nz + g.bz - 1) / g.bz, (g.ny + SWEEP_BY - 1) / SWEEP_BY);
  sweep_kernel<S><<<grid, SWEEP_THREADS, 0, stream>>>(
      static_cast<S*>(out), static_cast<const S*>(cur),
      static_cast<const S*>(prev), static_cast<const S*>(coeff), g, op);
  return (int)cudaGetLastError();
}

extern "C" {

// One time step on `stream`: out = sweep(cur, prev, coeff), every cell.
//   geo[4]      nz, ny, nx, bz
//   taps, groups, values, n_groups, time_order: the operator (make_op)
// Returns 0, a negative launcher error, or the cudaError_t of the launch.
int sweep_step(int stream_type, void* out, const void* cur,
               const void* prev, const void* coeff, const long long* geo,
               const long long* taps, int n_taps, const int* groups,
               const double* values, int n_groups, int time_order,
               int radius, int device, void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  SweepGeo g;
  g.nz = (int)geo[0]; g.ny = (int)geo[1]; g.nx = (int)geo[2];
  g.bz = (int)geo[3]; g.radius = radius;
  if (g.nz < 1 || g.ny < 1 || g.nx < 1 || g.bz < 1 || radius < 1
      || (g.ny + SWEEP_BY - 1) / SWEEP_BY > 65535)
    return E_GEOMETRY;
  g.sy = g.nx;
  g.sz = (long long)g.ny * g.nx;
  g.grid_elems = g.sz * g.nz;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stream_type) {
    case T_F32: return launch_step<float>(out, cur, prev, coeff, g, op, s);
    case T_F64: return launch_step<double>(out, cur, prev, coeff, g, op, s);
    case T_BF16:
      return launch_step<__nv_bfloat16>(out, cur, prev, coeff, g, op, s);
    case T_F16: return launch_step<__half>(out, cur, prev, coeff, g, op, s);
  }
  return E_TYPES;
}

const char* sweep_error_string(int code) {
  return stencil_error_string(code);
}

}  // extern "C"
