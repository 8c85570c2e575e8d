// K1 on Hopper: one diamond row of the multi-threaded wavefront diamond
// (MWD) advance, written by hand in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_mwd.py::_mwd_kernel
// (Pallas grid (row, tile, j), sequential on one TensorCore). Here:
//   * one launch per diamond row keeps the rows ordered on one stream;
//   * one thread block per (tile k, batch entry b) runs the tiles of a row
//     concurrently: tiles of one row only read, in their R-wide margin,
//     the parity level a same-row neighbour never writes (DESIGN.md sec. 4);
//   * inside the block, a loop over the wavefront steps j and, inside it,
//     the T = D_w/R in-tile updates tau, with a block barrier between them.
//     Update tau at step j targets padded z rows
//     [j*N_F - (tau+1)R, (j+1)*N_F - (tau+1)R), the y span [y0, y1) of the
//     schedule tables, and all x, each clipped to the dynamic interior.
//
// What bounds it on this card: bytes. The paper's stencils do 7-37 flops
// per lattice update against 24-128 bytes of streams, far below the H100's
// ~20 flop/byte ridge (67 TFLOP/s f32 over 3.35 TB/s). The TPU kernel keeps
// an N_F + R*T + R deep z-window of every stream in VMEM; at nx = 512 that
// window is ~226 KB per stream, more than one SM's 227 KB of shared memory
// for all streams together. This first design therefore keeps no
// shared-memory window: it updates the padded parity grids in place in
// global memory and leaves the reuse across the T updates and the j steps
// to L1/L2. It writes only the masked cells. A shared-memory z-ring with
// cp.async/TMA, x-blocking (MWDPlan.block_x) and a persistent row barrier
// are the known ways to cut the traffic, left for later work.
//
// Arithmetic: `update_cell` of stencil_cell.cuh, shared with K2 and K3,
// which rounds every operation to the accumulator type exactly as the plain
// PyTorch version (repro_torch.core.ir.sweep_region) does. Built with
// -fmad=false so no multiply-add is contracted and the two agree bit for
// bit. The update is in place: prev and out are the same parity grid.

#include <stdint.h>

#include "stencil_cell.cuh"

#define MWD_THREADS 512

struct Geo {
  long long grid_elems;   // elements of one padded grid (nz_tot*nyp*nxp)
  long long sz, sy;       // z and y strides (x is contiguous)
  int n_arrays;           // coefficient streams per batch entry
  int n_j, n_f, radius, t_steps, n_tiles;
  int lo_z, hi_z, lo_y, hi_y, lo_x, hi_x;   // interior, padded coordinates
  int skip_inactive;      // fused mode: tiles without spans do nothing
};

// One diamond row. Grid (n_tiles, batch); the tables are device int32:
// parity[n_rows], y0/y1[n_rows][n_tiles][T] (padded y), active[n_rows][n_tiles].
template <typename S, typename A>
__global__ void __launch_bounds__(MWD_THREADS)
mwd_row_kernel(S* buf_e, S* buf_o, const S* coeff,
               __grid_constant__ const Geo g, __grid_constant__ const Op op,
               const int* parity, const int* y0t, const int* y1t,
               const int* active, int row) {
  const long long tile = (long long)row * g.n_tiles + blockIdx.x;
  if (g.skip_inactive && active[tile] == 0) return;   // uniform per block
  const long long b = blockIdx.y;
  S* even = buf_e + b * g.grid_elems;
  S* odd = buf_o + b * g.grid_elems;
  const S* cf = coeff ? coeff + b * g.n_arrays * g.grid_elems : nullptr;
  const int p0 = parity[row];
  const int nxr = g.hi_x - g.lo_x;
  const int T = g.t_steps, R = g.radius, nf = g.n_f;
  for (int j = 0; j < g.n_j; ++j) {
    for (int tau = 0; tau < T; ++tau) {
      const int zs = j * nf - (tau + 1) * R;
      const int z0 = max(zs, g.lo_z), z1 = min(zs + nf, g.hi_z);
      const int ya = max(y0t[tile * T + tau], g.lo_y);
      const int yb = min(y1t[tile * T + tau], g.hi_y);
      if (z1 <= z0 || yb <= ya || nxr <= 0) continue;   // uniform per block
      const int pp = (p0 + tau) & 1;
      const S* src = pp ? odd : even;
      S* dst = pp ? even : odd;
      const int nyr = yb - ya;
      const int cells = (z1 - z0) * nyr * nxr;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const int x = i % nxr;
        const int t = i / nxr;
        const long long off = (long long)(z0 + t / nyr) * g.sz
            + (long long)(ya + t % nyr) * g.sy + (g.lo_x + x);
        update_cell<S, A>(src + off, op.tap_off, dst + off, dst + off,
                          cf, off, g.grid_elems, op);
      }
      __syncthreads();   // update tau+1 reads what update tau wrote
    }
  }
}

template <typename S, typename A>
static int launch_rows(void* buf_e, void* buf_o, const void* coeff,
                       const Geo& g, const Op& op, const int* tables,
                       int n_rows, int row_begin, int row_end, int batch,
                       cudaStream_t stream) {
  const long long n_tab = (long long)n_rows * g.n_tiles * g.t_steps;
  const int* parity = tables;
  const int* y0t = parity + n_rows;
  const int* y1t = y0t + n_tab;
  const int* active = y1t + n_tab;
  const dim3 grid(g.n_tiles, batch);
  for (int row = row_begin; row < row_end; ++row) {
    mwd_row_kernel<S, A><<<grid, MWD_THREADS, 0, stream>>>(
        static_cast<S*>(buf_e), static_cast<S*>(buf_o),
        static_cast<const S*>(coeff), g, op, parity, y0t, y1t, active, row);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" {

// Launch rows [row_begin, row_end) of the compiled schedule on `stream`.
//   geo[16]     grid_elems, sz, sy, n_arrays, n_j, n_f, radius, t_steps,
//               n_tiles, lo_z, hi_z, lo_y, hi_y, lo_x, hi_x, skip_inactive
//   taps[n]     linear tap offsets in group order
//   groups[3*G+2]  (count, kind, slot) per group, then (scale_kind, slot)
//   values[G+1] const value per group (0 for array groups), then the scale's
// Returns 0, a negative launcher error, or the cudaError_t of a launch.
int mwd_rows(int stream_type, int acc_type, void* buf_e, void* buf_o,
             const void* coeff, const long long* geo, const long long* taps,
             int n_taps, const int* groups, const double* values,
             int n_groups, int time_order, const int* tables, int n_rows,
             int row_begin, int row_end, int batch, int device,
             void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  Geo g;
  g.grid_elems = geo[0]; g.sz = geo[1]; g.sy = geo[2];
  g.n_arrays = (int)geo[3]; g.n_j = (int)geo[4]; g.n_f = (int)geo[5];
  g.radius = (int)geo[6]; g.t_steps = (int)geo[7]; g.n_tiles = (int)geo[8];
  g.lo_z = (int)geo[9]; g.hi_z = (int)geo[10]; g.lo_y = (int)geo[11];
  g.hi_y = (int)geo[12]; g.lo_x = (int)geo[13]; g.hi_x = (int)geo[14];
  g.skip_inactive = (int)geo[15];
  if (g.n_tiles < 1 || batch < 1 || batch > 65535 || g.n_f < 1
      || g.radius < 1 || row_begin < 0 || row_end > n_rows)
    return E_GEOMETRY;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* tab = tables;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MWD_LAUNCH(S, A) \
  launch_rows<S, A>(buf_e, buf_o, coeff, g, op, tab, n_rows, row_begin, \
                    row_end, batch, s)
  if (stream_type == acc_type) {
    switch (stream_type) {
      case T_F32: return MWD_LAUNCH(float, float);
      case T_F64: return MWD_LAUNCH(double, double);
      case T_BF16: return MWD_LAUNCH(__nv_bfloat16, __nv_bfloat16);
      case T_F16: return MWD_LAUNCH(__half, __half);
    }
  } else if (acc_type == T_F32) {
    switch (stream_type) {
      case T_BF16: return MWD_LAUNCH(__nv_bfloat16, float);
      case T_F16: return MWD_LAUNCH(__half, float);
    }
  }
#undef MWD_LAUNCH
  return E_TYPES;
}

const char* mwd_error_string(int code) {
  return stencil_error_string(code);
}

}  // extern "C"
