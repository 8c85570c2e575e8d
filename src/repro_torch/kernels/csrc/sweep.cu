// K2 on Hopper: one time step of the IR-generated sweep, spatially blocked
// (the paper's "optimal spatial blocking" baseline), written by hand in
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_sweep.py::_kernel
// (line 31: a Pallas grid over z-slabs of bz rows, each program copying a
// (bz+2R)-row window of every edge-padded stream into VMEM and emitting bz
// rows).
//
// What bounds it on this card: bytes. One step must read each input stream
// once and write one grid, (N_D + 1) words per update; the 7-37 flops per
// update sit far below the H100's ~20 flop/byte ridge. So the design is the
// paper's optimal spatial blocking, 2.5-D streaming in z: each input byte
// comes from HBM once and each output byte goes back once. Measured, the
// kernel runs at 38-69 % of that bound; what holds it above is the update
// itself at the residency the ring leaves, most at R = 4 (PERF.md).
//   * One launch per time step on the caller's stream; one CTA per (z chunk,
//     y tile of ty rows, x tile of tx columns), the chunk a whole multiple
//     of the caller's bz. Results do not depend on the tiling: each cell is
//     the same update of the same inputs whichever CTA computes it, so the
//     host picks the tile, threads, chunk, loads ahead, instance and copy
//     path (stencil_sweep.choose_tile, from chip_smoke.py --sweep-k2) and
//     hands the ring layout over in `geo` (stencil_sweep.tile_layout).
//   * The CTA walks its chunk plane by plane and keeps cur in one
//     shared-memory ring of 2R + 1 + ahead planes over its tile, widened by
//     R rows in y and by R rounded up to 16 bytes in x, clipped to the
//     grid. Plane k sits in slot k % depth and is loaded with cp.async (16
//     bytes a copy where rows are aligned) `ahead` steps before the step
//     that first reads it. A cur byte then crosses from L2 to the SM about
//     (ty + 2R)(tx + 2mx)(chunk + 2R) / (ty tx chunk) times a step, where
//     loading every tap from global memory brought it about 6 times at
//     R = 4. One cp.async.bulk per row completed on an mbarrier (the TMA
//     unit without a tensor map) measured slower on three of the four
//     paper ops and no faster on the fourth (PERF.md), so it was dropped.
//   * A cell reads its taps from the ring through one offset table per
//     ring slot, built once per CTA from the op's (dz, dy, dx), as K1 and
//     K3 do. prev and the coefficient streams are read once, at the cell,
//     from global memory: pure streams, so what counts is the bytes in
//     flight. Instances for ops with array-coefficient groups issue the
//     loads of the first 8 or 16 groups together (update_cell's H), and the
//     host may have the tile's rows of those streams prefetched into L2 a
//     few planes before the step that reads them. Staging them in shared
//     memory by the same copies as cur measured no faster at 7pt-var and
//     slower at the 25-point ops, where it cost residency (PERF.md).
//   * A thread updates V cells of a row 32 columns apart (V = 4, 2 in f64,
//     1 where coefficient loads are hoisted), so the V cells share each
//     tap's table entry and address and their loads are in flight
//     together; a warp covers 32 V consecutive columns and each store of a
//     warp writes 32 consecutive cells (a whole 128-byte line where the row
//     is aligned; rows of any width, nx = 29, work). Measured on an H100,
//     staging the output tile in shared memory for 16-byte stores ran
//     slower (PERF.md), so stores go straight from registers.
//   * Frame rows and planes are copied from cur's plane in the ring. In an
//     interior row every cell is updated, all its taps lying in the ring
//     slot, and the frame columns are then copied over it, so no warp
//     falls back to one cell at a time at the x edges of the grid (where
//     half the tiles of a 512-wide grid lie). Every cell of `out` is
//     written, so the host makes no clone; no padded copy exists, since no
//     interior cell reads beyond the grid. Out of place: cur, prev and the
//     coefficients are only read.
//   * Where no ring fits shared memory (a radius far beyond the paper's)
//     the host picks the in-place instance: taps read from cur through
//     L1/L2, a row with frame cells one cell at a time (a frame cell's taps
//     may leave the grid).
//
// Why no interior cell reads a stale or missing ring cell. An updated cell
// lies in an interior row of an interior plane of the tile, so its taps lie
// in the tile's box widened by R (at least R in x), inside the ring's rows
// and columns, and in planes p - R ... p + R, which the ring holds at step
// p. The load issued at step p goes to the slot of plane p - R - 1, last
// read in step p - 1, behind the barrier that opens step p. An interior
// cell's taps lie in the grid, so they were loaded; only a frame column's
// taps may reach cells the box clips off (never loaded), and its result is
// replaced by cur's value.
//
// Arithmetic: `update_cell<S, S, V, H>` of stencil_cell.cuh in the stream
// type, as the reference has no accumulator option; the order of
// operations, and so the bits, is the same for every V and H. Built with
// -fmad=false, so it agrees bit for bit with the plain PyTorch version
// (repro_torch.core.ir).

#include "async_copy.cuh"
#include "stencil_cell.cuh"

#define SWEEP_MAX_THREADS 1024
#define SWEEP_MAX_AHEAD 2       // planes loaded ahead (cp_async_wait's reach)
#define SWEEP_MAX_SMEM 232448   // dynamic shared memory a block may take
#define SWEEP_MAX_PREFETCH 16   // planes of the streams prefetched into L2
// cells a thread updates at once, 32 columns apart: four (two of 8-byte
// words) where no coefficient load is hoisted, else one, so that every
// instance fits 64 registers
#define SWEEP_CELLS(hoist, elem) ((hoist) != 0 ? 1 : (elem) == 8 ? 2 : 4)

struct SweepGeo {
  long long sz;           // grid z stride, ny*nx (y stride nx, x contiguous)
  long long grid_elems;   // one grid, nz*ny*nx
  int nz, ny, nx, chunk, ty, tx, threads, radius, ahead, hoist, ring;
  int n_arrays, n_taps, smem_bytes, tab_ints;
  // the ring (stencil_sweep.TilePlan): ring cell (y, x) of the CTA whose
  // tile starts at (cy, cx) is grid cell (cy - my + y, cx - mx + x); rows
  // of `width` cells, `height` rows, `depth` planes, from byte `base` of
  // the dynamic shared memory, after the tap table
  int mx, my, width, height, depth, base;
  // planes before the step that reads them at which the tile's rows of
  // prev and the coefficient streams are prefetched into L2 (0: never)
  int prefetch;
  int ntx, nty;           // tiles in x and in y
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// One step. A 1-D grid of CTAs, x tiles fastest, then y tiles, then z
// chunks; `kRing`: cur streams through the shared-memory ring, else its
// taps are read in place; `kHoist`: the array-coefficient groups whose
// loads update_cell issues together. Every instance keeps to 64 registers
// a thread, so 1024 threads fill an SM's registers whatever the split into
// CTAs.
template <typename S, bool kRing, int kHoist>
__global__ void __launch_bounds__(SWEEP_MAX_THREADS, 1)
sweep_kernel(S* __restrict__ out, const S* __restrict__ cur,
             const S* __restrict__ prev, const S* __restrict__ coeff,
             __grid_constant__ const SweepGeo g,
             __grid_constant__ const Op op,
             __grid_constant__ const TapDelta td) {
  constexpr int V = SWEEP_CELLS(kHoist, sizeof(S));
  extern __shared__ __align__(16) unsigned char smem[];
  int* const tab = reinterpret_cast<int*>(smem);
  S* const ring = reinterpret_cast<S*>(smem + g.base);
  const int R = g.radius, nthr = blockDim.x, D = g.depth;
  const int rest = blockIdx.x / g.ntx;
  const int cx = (blockIdx.x - rest * g.ntx) * g.tx;
  const int zc = rest / g.nty;
  const int cy = (rest - zc * g.nty) * g.ty;
  const int cz = zc * g.chunk;
  const int ex = min(cx + g.tx, g.nx), ey = min(cy + g.ty, g.ny);
  const int ez = min(cz + g.chunk, g.nz);
  // the thread's cells: columns x + 32 v (v < V) of rows y0, y0 + ry, ...;
  // a warp covers 32 V consecutive columns of a row
  const int h = g.tx / V, ry = nthr / h, xi = (int)threadIdx.x % h;
  const int x = cx + (xi & ~31) * V + (xi & 31);
  const int y0 = cy + (int)threadIdx.x / h;
  int n = 1;
#pragma unroll
  for (int v = 1; v < V; ++v) n += x + 32 * v < ex;
  // the ring's planes [zl, zh), rows [ry0, ry1) and columns [rx0, rx1),
  // and the grid cell (oy, ox) of its cell (0, 0)
  const int plane = g.width * g.height;
  const int oy = cy - g.my, ox = cx - g.mx;
  const int zl = max(cz - R, 0), zh = min(ez + R, g.nz);
  const int ry0 = max(oy, 0), ry1 = min(oy + g.height, g.ny);
  const int rx0 = max(ox, 0), rx1 = min(ox + g.width, g.nx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if constexpr (kRing) {
    for (int i = threadIdx.x; i < D * g.n_taps; i += nthr) {
      const int j = i / g.n_taps, t = i - j * g.n_taps;
      const int j2 = ((j + td.dz[t]) % D + D) % D;
      tab[i] = (j2 - j) * plane + td.dy[t] * g.width + td.dx[t];
    }
    __syncthreads();
  }

  // cur's plane k to its slot, a warp a row (nothing outside [zl, zh)); one
  // cp.async group a call, empty or not
  auto load = [&](int k) {
    if (k >= zl && k < zh) {
      S* dst = ring + (k % D) * plane + (ry0 - oy) * g.width + (rx0 - ox);
      const S* src = cur + (long long)k * g.sz + (long long)ry0 * g.nx + rx0;
      for (int y = warp; y < ry1 - ry0; y += nthr >> 5)
        copy_row(dst + y * g.width, src + (long long)y * g.nx, rx1 - rx0,
                 lane);
    }
    cp_async_commit();
  };
  // prev and the coefficient streams over the tile's rows of plane q into
  // L2, a 128-byte line a thread
  auto prefetch = [&](int q) {
    constexpr int L = 128 / (int)sizeof(S);     // elements a line
    const int rows = ey - cy, lines = (ex - cx + L - 1) / L + 1;
    const int n_s = g.n_arrays + (op.time_order == 2);
    const long long at = (long long)q * g.sz + (long long)cy * g.nx + cx;
    for (int i = threadIdx.x; i < n_s * rows * lines; i += nthr) {
      const int r = i / lines, l = i - r * lines;
      const int a = r / rows, y = r - a * rows;
      const S* base = a < g.n_arrays ? coeff + a * g.grid_elems : prev;
      prefetch_l2(base + at + (long long)y * g.nx + min(l * L, ex - cx - 1));
    }
  };

  if constexpr (kRing)
    for (int k = cz - R; k < cz + R + g.ahead; ++k) load(k);
  for (int q = cz; q < min(cz + g.prefetch, ez); ++q) prefetch(q);
  for (int p = cz; p < ez; ++p) {
    if constexpr (kRing) {
      cp_async_wait(g.ahead - 1);
      __syncthreads();                  // planes in; the last step done
      load(p + R + g.ahead);
    }
    if (g.prefetch > 0 && p + g.prefetch < ez) prefetch(p + g.prefetch);
    if (x >= ex) continue;              // no column of this tile
    const long long pl = (long long)p * g.sz;
    const bool frame_plane = p < R || p >= g.nz - R;
    const bool inner = !frame_plane && cy >= R && ey <= g.ny - R
        && cx >= R && ex <= g.nx - R;
    // the thread's cells of plane p, with cur's plane at `src` (cell (y, x)
    // at src[y * sw + x]) and the taps at `taps`: the ring slot and its
    // table, so that the taps compile to shared-memory loads, or cur itself
    // and the grid's tap offsets. A row of the frame is copied; in a ring
    // every tap of a tile cell lies in its slot, so an interior row updates
    // all its cells together and then copies its frame columns over them;
    // in place, a tap of a frame cell may leave the grid, so a row with
    // frame cells goes one cell at a time.
    auto cells = [&](const S* src, auto sw, const auto* taps) {
      for (int y = y0; y < ey; y += ry) {
        const long long go = pl + (long long)y * g.nx + x;
        const S* in = src + y * sw + x;
        S* const dst = out + go;
        if (frame_plane || y < R || y >= g.ny - R) {
          for (int v = 0; v < n; ++v) dst[32 * v] = in[32 * v];
          continue;
        }
        const bool edge = x < R || x + 32 * (n - 1) >= g.nx - R;
        if (kRing || inner || !edge) {
          update_cell<S, S, V, kHoist>(in, taps, prev + go, dst, coeff, go,
                                       g.grid_elems, op, 32, n);
          if (edge)
            for (int v = 0; v < n; ++v)
              if (x + 32 * v < R || x + 32 * v >= g.nx - R)
                dst[32 * v] = in[32 * v];
        } else {
          for (int v = 0; v < n; ++v) {
            const int xv = x + 32 * v, o = 32 * v;
            if (xv < R || xv >= g.nx - R)
              dst[o] = in[o];
            else
              update_cell<S, S>(in + o, taps, prev + go + o, dst + o, coeff,
                                go + o, g.grid_elems, op);
          }
        }
      }
    };
    if constexpr (kRing) {
      const int j = p % D;
      cells(ring + (j * plane - oy * g.width - ox), g.width,
            tab + j * g.n_taps);
    } else {
      cells(cur + pl, (long long)g.nx, op.tap_off);
    }
  }
}

// The instance for a stream type, ring and hoisted groups: 0, 8 or 16, the
// fewest that cover the op's array-coefficient groups; the in-place path
// is built without hoisted loads only.
template <typename S>
static void* pick(int ring, int hoist) {
  if (!ring) return (void*)sweep_kernel<S, false, 0>;
  return hoist == 0 ? (void*)sweep_kernel<S, true, 0>
       : hoist == 8 ? (void*)sweep_kernel<S, true, 8>
                    : (void*)sweep_kernel<S, true, 16>;
}

static int elem_size(int stream_type) {
  switch (stream_type) {
    case T_F32: return 4;
    case T_F64: return 8;
    case T_BF16: case T_F16: return 2;
  }
  return 0;
}

static void* kernel_of(int stream_type, const SweepGeo& g) {
  switch (stream_type) {
    case T_F32: return pick<float>(g.ring, g.hoist);
    case T_F64: return pick<double>(g.ring, g.hoist);
    case T_BF16: return pick<__nv_bfloat16>(g.ring, g.hoist);
    case T_F16: return pick<__half>(g.ring, g.hoist);
  }
  return nullptr;
}

// geo: nz, ny, nx, chunk, ty, tx, threads, radius, ahead, hoisted groups
//      (0, 8 or 16), ring (0: taps in place), n_arrays, smem_bytes,
//      tab_ints, then the ring: mx, my, width, height, depth, base (zeros
//      in place), then prefetch (stencil_sweep._geometry)
#define SWEEP_GEO_LEN 21
static int read_geo(const long long* geo, int elem, int n_taps, SweepGeo& g) {
  for (int i = 0; i < SWEEP_GEO_LEN; ++i)
    if (geo[i] < 0 || geo[i] >= (1LL << 31)) return E_GEOMETRY;
  g = SweepGeo{};
  g.nz = (int)geo[0]; g.ny = (int)geo[1]; g.nx = (int)geo[2];
  g.chunk = (int)geo[3]; g.ty = (int)geo[4]; g.tx = (int)geo[5];
  g.threads = (int)geo[6]; g.radius = (int)geo[7]; g.ahead = (int)geo[8];
  g.hoist = (int)geo[9]; g.ring = (int)geo[10]; g.n_arrays = (int)geo[11];
  g.smem_bytes = (int)geo[12]; g.tab_ints = (int)geo[13];
  g.mx = (int)geo[14]; g.my = (int)geo[15]; g.width = (int)geo[16];
  g.height = (int)geo[17]; g.depth = (int)geo[18]; g.base = (int)geo[19];
  g.prefetch = (int)geo[20];
  g.n_taps = n_taps;
  const int V = SWEEP_CELLS(g.hoist, elem), e = elem > 0 ? 16 / elem : 1;
  if (elem == 0 || g.nz < 1 || g.ny < 1 || g.nx < 1 || g.chunk < 1
      || g.smem_bytes > SWEEP_MAX_SMEM
      || g.ty < 1 || g.tx < 1 || g.radius < 1 || g.tx % (32 * V)
      || g.threads < 32 || g.threads % 32 || g.threads > SWEEP_MAX_THREADS
      || g.tx / V > g.threads || g.threads % (g.tx / V)
      || (g.hoist != 0 && g.hoist != 8 && g.hoist != 16)
      || g.ring > 1 || (!g.ring && g.hoist != 0)
      || g.prefetch > SWEEP_MAX_PREFETCH)
    return E_GEOMETRY;
  g.ntx = (g.nx + g.tx - 1) / g.tx;
  g.nty = (g.ny + g.ty - 1) / g.ty;
  const long long nzc = (g.nz + (long long)g.chunk - 1) / g.chunk;
  if ((long long)g.ntx * g.nty * nzc >= (1LL << 31)) return E_GEOMETRY;
  if (g.ring) {
    const long long ring_bytes =
        (long long)g.depth * g.height * g.width * elem;
    if (g.ahead < 1 || g.ahead > SWEEP_MAX_AHEAD
        || g.depth != 2 * g.radius + 1 + g.ahead || g.radius > 127
        || g.mx < g.radius || g.my < g.radius
        || g.height < g.ty + 2 * g.radius
        || g.width < g.mx + g.tx + g.radius
        || g.mx % e || g.width % e || g.tx % e
        || g.tab_ints != g.depth * n_taps
        || 4LL * g.tab_ints > g.base || g.base % 16
        || g.base + ring_bytes > g.smem_bytes)
      return E_GEOMETRY;
  }
  g.sz = (long long)g.ny * g.nx;
  g.grid_elems = g.sz * g.nz;
  return 0;
}

extern "C" {

// One time step on `stream`: out = sweep(cur, prev, coeff), every cell.
//   geo          see read_geo (stencil_sweep._geometry)
//   taps[n]      linear tap offsets in grid layout, group order
//   taps3[3n]    (dz, dy, dx) of the same taps
//   groups, values, n_groups, time_order: the operator (make_op)
// Returns 0, a negative launcher error, or the cudaError_t of the launch.
int sweep_step(int stream_type, void* out, const void* cur,
               const void* prev, const void* coeff, const long long* geo,
               const long long* taps, const int* taps3, int n_taps,
               const int* groups, const double* values, int n_groups,
               int time_order, int device, void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  SweepGeo g;
  if (read_geo(geo, elem_size(stream_type), n_taps, g)) return E_GEOMETRY;
  TapDelta td = {};
  if (g.ring && make_tap_delta(td, taps3, n_taps, g.radius)) return E_OP;
  if (g.n_arrays > 0 && coeff == nullptr) return E_GEOMETRY;
  void* fn = kernel_of(stream_type, g);
  if (fn == nullptr) return E_TYPES;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)g.ntx * g.nty
      * ((g.nz + (long long)g.chunk - 1) / g.chunk);
  void* args[] = {&out, &cur, &prev, &coeff, &g, &op, &td};
  err = cudaLaunchKernel(fn, dim3((unsigned)ctas), dim3(g.threads), args,
                         g.smem_bytes, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The resident CTAs per SM of the kernel sweep_step would launch for `geo`,
// by the occupancy API: out[0].
int sweep_config(int stream_type, const long long* geo, int n_taps,
                 int device, int* out) {
  SweepGeo g;
  if (read_geo(geo, elem_size(stream_type), n_taps, g)) return E_GEOMETRY;
  void* fn = kernel_of(stream_type, g);
  if (fn == nullptr) return E_TYPES;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, g.threads,
                                                        g.smem_bytes);
  return (int)err;
}

const char* sweep_error_string(int code) {
  return stencil_error_string(code);
}

}  // extern "C"
