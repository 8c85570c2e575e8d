// K3 on Hopper: one ghost-zone pass of temporal blocking (t_block time
// steps on each (z, y) block, the halo recomputed redundantly), written by
// hand in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_fused.py::_kernel
// (Pallas grid over (z, y) blocks, each program copying a
// (bz+2g, by+2g, nx+2g) window, g = R*t_block, of every edge-padded stream
// into VMEM, running t_block sweeps there with the Dirichlet frame restored
// after each, and writing the un-haloed centre of both levels). Here:
//   * one launch per pass; a persistent grid of a few blocks per SM, each
//     block looping over the (z, y) tiles;
//   * the window does not fit shared memory (one stream at 512^3 is 1.2 MB
//     for the 7-point ops, 5 MB for the 25-point ones, against 227 KB per
//     block), so each block keeps two block-private ping-pong windows in
//     global scratch and leaves reuse to L1/L2, with a block barrier between
//     the t_block steps. The scratch is grid size x 2 windows, not one per
//     tile;
//   * windows are clamped to the grid instead of padded: pad cells are
//     frame-masked in the reference and no interior tap leaves the grid, so
//     no valid centre cell ever depends on one. Step s updates only the box
//     the centre still needs, (t_block - s)*R wide around it, so nothing
//     stale is ever read and the first step's ping-pong window is written
//     before it is read;
//   * frame cells are copied from cur, which the kernel only reads; no
//     per-block copy of the frame window is made, and the inputs are never
//     written (a neighbour's halo reads them in the same launch). The last
//     step writes the centre straight into out_cur, and the centre of the
//     level before it is copied to out_prev: both outputs are complete
//     grids, frame included, so the host makes no clone.
//
// What bounds it on this card: bytes. A pass reads each input stream once
// and writes two grids, (N_D + 1) words per t_block updates; the redundant
// halo updates cost operations, still below the H100's ~20 flop/byte ridge.
//
// Arithmetic: `update_cell` of stencil_cell.cuh in the stream type, as the
// reference has no accumulator option. Built with -fmad=false, so it agrees
// bit for bit with the plain PyTorch version (repro_torch.core.ir).

#include "stencil_cell.cuh"

#define FUSED_THREADS 512

struct FusedGeo {
  long long grid_elems;   // elements of one grid (nz*ny*nx)
  long long sz, sy;       // grid z and y strides (x is contiguous)
  long long win_elems;    // one scratch window, (bz+2g)*(by+2g)*nx
  long long wsz;          // window z stride, (by+2g)*nx; y stride is nx
  int nz, ny, nx, bz, by, radius, t_block, n_ty, n_tiles;
};

// tap offsets in the window layout, group order
struct WinTaps {
  int off[STENCIL_MAX_TAPS];
};

// One step over the box [z0,z1) x [y0,y1) x [0,nx): frame cells copied
// from cur, interior cells computed from `src` (read at `taps`) and `prv`
// into `dst`. Each of src, prv and dst lies in grid layout or in this
// block's window (origin wz0, wy0); the `*_win` flags say which.
template <typename S, typename Off>
__device__ __forceinline__ void pass_step(
    const S* src, const Off* taps, bool src_win, const S* prv, bool prv_win,
    S* dst, bool dst_win, const S* cur, const S* coeff, const FusedGeo& g,
    const Op& op, int z0, int z1, int y0, int y1, int wz0, int wy0) {
  const int R = g.radius;
  const int nyr = y1 - y0;
  const int cells = (z1 - z0) * nyr * g.nx;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int x = i % g.nx;
    const int t = i / g.nx;
    const int y = y0 + t % nyr, z = z0 + t / nyr;
    const long long goff = (long long)z * g.sz + (long long)y * g.sy + x;
    const long long woff = (long long)(z - wz0) * g.wsz
        + (long long)(y - wy0) * g.nx + x;
    S* d = dst + (dst_win ? woff : goff);
    if (z < R || z >= g.nz - R || y < R || y >= g.ny - R || x < R
        || x >= g.nx - R)
      *d = cur[goff];
    else
      update_cell<S, S>(src + (src_win ? woff : goff), taps,
                        prv + (prv_win ? woff : goff), d, coeff, goff,
                        g.grid_elems, op);
  }
}

// Level s of the pass lives in: s = -1 prev, s = 0 cur (the inputs),
// 1 <= s < t_block the window buf[s & 1], s = t_block out_cur.
template <typename S>
__global__ void __launch_bounds__(FUSED_THREADS)
fused_kernel(S* out_cur, S* out_prev, S* scratch, const S* cur,
             const S* prev, const S* coeff, __grid_constant__ const FusedGeo g,
             __grid_constant__ const WinTaps wt,
             __grid_constant__ const Op op) {
  S* buf[2];
  buf[0] = scratch + (long long)blockIdx.x * 2 * g.win_elems;
  buf[1] = buf[0] + g.win_elems;
  const int R = g.radius, T = g.t_block;
  for (int tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    const int cz = (tile / g.n_ty) * g.bz, cy = (tile % g.n_ty) * g.by;
    const int wz0 = max(cz - R * T, 0), wy0 = max(cy - R * T, 0);
    for (int s = 1; s <= T; ++s) {
      const int m = (T - s) * R;          // margin the centre still needs
      const int z0 = max(cz - m, 0), z1 = min(cz + g.bz + m, g.nz);
      const int y0 = max(cy - m, 0), y1 = min(cy + g.by + m, g.ny);
      const S* prv = s == 1 ? prev : s == 2 ? cur : buf[s & 1];
      S* dst = s == T ? out_cur : buf[s & 1];
      if (s == 1)
        pass_step<S>(cur, op.tap_off, false, prv, false, dst, s < T, cur,
                     coeff, g, op, z0, z1, y0, y1, wz0, wy0);
      else
        pass_step<S>(buf[(s - 1) & 1], wt.off, true, prv, s >= 3, dst,
                     s < T, cur, coeff, g, op, z0, z1, y0, y1, wz0, wy0);
      __syncthreads();   // step s+1 reads what step s wrote
    }
    // the centre of level T-1 is the new prev
    const int z1 = min(cz + g.bz, g.nz), y1 = min(cy + g.by, g.ny);
    const int nyr = y1 - cy;
    const int cells = (z1 - cz) * nyr * g.nx;
    const S* last = buf[(T - 1) & 1];
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int x = i % g.nx;
      const int t = i / g.nx;
      const int y = cy + t % nyr, z = cz + t / nyr;
      const long long goff = (long long)z * g.sz + (long long)y * g.sy + x;
      out_prev[goff] = T == 1 ? cur[goff]
          : last[(long long)(z - wz0) * g.wsz + (long long)(y - wy0) * g.nx
                 + x];
    }
    __syncthreads();     // the next tile overwrites the windows
  }
}

template <typename S>
static int launch_pass(void* out_cur, void* out_prev, void* scratch,
                       const void* cur, const void* prev, const void* coeff,
                       const FusedGeo& g, const WinTaps& wt, const Op& op,
                       int n_blocks, cudaStream_t stream) {
  fused_kernel<S><<<n_blocks, FUSED_THREADS, 0, stream>>>(
      static_cast<S*>(out_cur), static_cast<S*>(out_prev),
      static_cast<S*>(scratch), static_cast<const S*>(cur),
      static_cast<const S*>(prev), static_cast<const S*>(coeff), g, wt, op);
  return (int)cudaGetLastError();
}

extern "C" {

// One pass of t_block steps on `stream`: (out_cur, out_prev) = the state
// after t_block and t_block - 1 steps, every cell.
//   geo[7]       nz, ny, nx, bz, by, t_block, n_blocks
//   scratch      n_blocks * 2 * (bz+2g)*(by+2g)*nx elements, g = R*t_block
//   taps         tap offsets in grid layout; win_taps in window layout
//   groups, values, n_groups, time_order: the operator (make_op)
// Returns 0, a negative launcher error, or the cudaError_t of the launch.
int fused_pass(int stream_type, void* out_cur, void* out_prev,
               void* scratch, const void* cur, const void* prev,
               const void* coeff, const long long* geo,
               const long long* taps, const int* win_taps, int n_taps,
               const int* groups, const double* values, int n_groups,
               int time_order, int radius, int device, void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  FusedGeo g;
  g.nz = (int)geo[0]; g.ny = (int)geo[1]; g.nx = (int)geo[2];
  g.bz = (int)geo[3]; g.by = (int)geo[4]; g.t_block = (int)geo[5];
  const int n_blocks = (int)geo[6];
  g.radius = radius;
  if (g.nz < 1 || g.ny < 1 || g.nx < 1 || g.bz < 1 || g.by < 1
      || g.t_block < 1 || n_blocks < 1 || radius < 1)
    return E_GEOMETRY;
  const long long halo = 2LL * radius * g.t_block;
  g.sy = g.nx;
  g.sz = (long long)g.ny * g.nx;
  g.grid_elems = g.sz * g.nz;
  g.wsz = (g.by + halo) * g.nx;
  g.win_elems = (g.bz + halo) * g.wsz;
  if (g.win_elems >= (1LL << 31)) return E_GEOMETRY;   // int cell indices
  g.n_ty = (g.ny + g.by - 1) / g.by;
  g.n_tiles = ((g.nz + g.bz - 1) / g.bz) * g.n_ty;
  WinTaps wt;
  for (int t = 0; t < n_taps; ++t) wt.off[t] = win_taps[t];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_LAUNCH(S) \
  launch_pass<S>(out_cur, out_prev, scratch, cur, prev, coeff, g, wt, op, \
                 n_blocks, s)
  switch (stream_type) {
    case T_F32: return FUSED_LAUNCH(float);
    case T_F64: return FUSED_LAUNCH(double);
    case T_BF16: return FUSED_LAUNCH(__nv_bfloat16);
    case T_F16: return FUSED_LAUNCH(__half);
  }
#undef FUSED_LAUNCH
  return E_TYPES;
}

const char* fused_error_string(int code) {
  return stencil_error_string(code);
}

}  // extern "C"
