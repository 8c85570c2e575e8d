// K1 on Hopper: one diamond row of the multi-threaded wavefront diamond
// (MWD) advance, written by hand in CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_mwd.py::_mwd_kernel
// (Pallas grid (row, tile, j), sequential on one TensorCore, with a VMEM
// z-window of every stream per tile).
//
// What bounds it on this card: bytes, in principle. The paper's stencils
// do 7-37 flops per lattice update against 24-128 bytes of streams, far
// below the H100's ~20 flop/byte ridge (67 TFLOP/s f32 over 3.35 TB/s);
// the schedule itself streams every parity grid (D_w + 2R)/D_w times and
// every coefficient stream once per diamond row. In practice the
// wavefront's chain of dependent updates sets the pace: N_J * T updates per
// tile and row, each ended by a barrier (PERF.md has the measured split).
//
// Design: one diamond tile is shared by a thread group, the paper's
// intra-tile parallelism. On Hopper the group is a thread-block cluster:
//   * one launch per diamond row keeps the rows ordered on one stream;
//   * one cluster per (tile, batch entry); its CTAs split the interior x
//     range into contiguous slabs of `slab` columns (the last may be
//     narrower), so the cluster covers the full x width of the tile;
//   * each CTA keeps a shared-memory z-ring of both parity windows,
//     (ahead + 1)*N_F + R*T + R rows x (D_w + 2R) y x (slab + 2R) x, row z
//     at ring slot z mod depth, rows padded to 16 bytes. Step j streams
//     padded rows [j*N_F, (j+1)*N_F) in with cp.async (16 bytes at a time
//     where aligned) `ahead` steps before they are used, into slots whose
//     rows are dead, so the loads overlap the updates;
//   * update tau of step j targets padded rows
//     [j*N_F - (tau+1)R, (j+1)*N_F - (tau+1)R), the y span [y0, y1) of the
//     schedule tables and the CTA's own columns, each clipped to the
//     dynamic interior. A warp takes one (z, y) row at a time, each lane
//     MWD_CELLS cells 32 columns apart. Tap offsets wrap with the ring, so
//     every tap goes through a per-slot offset table built once per CTA;
//     except in the star instances (kStar > 0: the paper's four operators,
//     the 7-point adjoints and 7pt-const's masked twin, `Star` in
//     stencil_cell.cuh), where a row keeps the 2R wrapped ring-plane
//     offsets of its z taps in registers, the y and x offsets follow from
//     the window's row stride, and a cell's loads run ahead of its
//     additions (the table's shared memory stays reserved, so the plan
//     does not move);
//   * x-halos: a thread that writes one of the R boundary columns of its
//     slab also stores the value into the neighbour CTA's halo column
//     through distributed shared memory, and a cluster barrier
//     (arrive.release / wait.acquire) ends the update. An update pushes
//     only if a later update of the tile reads the parity it writes (one an
//     odd number of updates on, with cells); the others end with a block
//     barrier. At dw8 that is every update but the last of a step at the
//     7-point ops, and none at the 25-point ops, whose only update per step
//     reads no level of this row. The halo of a freshly streamed slab comes
//     from global memory: nothing in the cluster has touched those rows
//     yet, since emission trails by D_w;
//   * the coefficient streams are read only at the updated cell, which is
//     always interior, and addressed unpadded (padded coordinate - (pz, py,
//     px)). They are staged in a second ring without halo (depth
//     (ahead + 1)*N_F + R*(T-1), the tile's own D_w y rows, the slab's
//     columns, R rows behind the parity slabs) only where that keeps as
//     many CTAs per SM; otherwise they are read in place, prefetched into
//     L2 a step ahead and into L1 a row ahead;
//   * a finished slab leaves through ring rows [j*N_F - D_w, +N_F) once
//     j >= D_w/N_F: both parities, the tile's own D_w rows
//     [w0+R, w0+R+D_w) and the CTA's own columns, as the reference emits.
//
// Tiles of one row run at once in place (DESIGN.md sec. 4): a tile reads
// its neighbour's cells only in its R-wide y margin, only at its centre
// time, and only the parity level the neighbour's single update of those
// cells leaves untouched. Emission rewrites a tile's own D_w rows only,
// and for every cell the tile did not update it writes back the value it
// streamed in, which no other tile of the row changes; so a neighbour that
// streams the margin before or after the emission reads the same level.
//
// Control flow that a cluster barrier depends on (the spans, the interior
// clip, the active mask, the step count) is uniform across the cluster.
//
// Arithmetic: `update_cell` of stencil_cell.cuh, shared with K2 and K3 (here
// at MWD_CELLS cells per lane, in its star form in the star instances),
// which rounds every operation to the accumulator type exactly as the plain
// PyTorch version (repro_torch.core.ir.sweep_region) does. Built with
// -fmad=false so no multiply-add is contracted and the two agree bit for
// bit. The tap and group order is op.groups order.

#include <cooperative_groups.h>

#include <type_traits>

#include "async_copy.cuh"
#include "stencil_cell.cuh"

namespace cg = cooperative_groups;

#define MWD_MAX_THREADS 512
#define MWD_PORTABLE_CLUSTER 8
#define MWD_MAX_CLUSTER 16
#define MWD_SLAB_TARGET 64   // x columns per CTA that the launcher aims for
#define MWD_MAX_T 64         // in-tile updates per pass (D_w / R)
#define MWD_CELLS 2          // cells per lane and row, 32 columns apart

// launcher errors of this kernel (stencil_cell.cuh holds -1..-3)
enum { E_CLUSTER = -4, E_SMEM = -5, E_CLUSTER_SIZE = -6 };

struct Geo {
  long long grid_elems;   // elements of one padded parity grid
  long long sz, sy;       // padded z and y strides (x is contiguous)
  long long coeff_elems;  // elements of one unpadded coefficient stream
  long long csz, csy;     // unpadded strides
  int n_arrays, n_j, n_f, radius, t_steps, n_tiles, d_w;
  int lo_z, hi_z, lo_y, hi_y, lo_x, hi_x;   // interior, padded coordinates
  int nz, ny, pz, py, px;                   // unpadded extent, pad offsets
  int skip_inactive;      // fused mode: tiles without spans do nothing
  int n_taps;
  int n_array_groups;       // groups with array coefficients
  int exchange;             // some update pushes halos: launch as clusters
  int cluster_req;          // CTAs per tile the caller asks for (0: choose)
  // chosen by the launcher
  int cluster, slab;
  int ahead;                              // slabs in flight (1 or 2)
  int depth, cdepth, wy, wx;              // ring depths, window extents
  int tab_bytes;                          // tap table, ahead of the rings
};

// all threads of the cluster: prior shared and distributed shared memory
// writes released before, acquired after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The taps of the cells of a row in ring slot `slot`: its row of the
// per-slot table, or, in a star instance, the row's `StarTaps`.
template <int kStar>
__device__ __forceinline__ auto row_taps(const int* row, int slot, int depth,
                                         int plane, int wx) {
  if constexpr (kStar > 0)
    return StarTaps<kStar>(slot, depth, plane, wx);
  else
    return row;
}

// One diamond row. Grid (n_tiles * cluster, batch), clusters (cluster, 1, 1);
// the tables are device int32: parity[n_rows], w0/active[n_rows][n_tiles]
// (padded y), y0/y1[n_rows][n_tiles][T] (padded y). A warp updates one
// (z, y) row of the CTA's slab at a time, each lane MWD_CELLS cells 32
// columns apart. kStar: 0 for any op (taps through the per-slot table), or
// the op's compile-time star layout (`Star`).
template <typename S, typename A, bool kStage, int kHoist, int kStar>
__global__ void __launch_bounds__(MWD_MAX_THREADS)
mwd_row_kernel(S* buf_e, S* buf_o, const S* __restrict__ coeff,
               __grid_constant__ const Geo g, __grid_constant__ const Op op,
               __grid_constant__ const TapDelta td, const int* parity,
               const int* w0t, const int* y0t, const int* y1t,
               const int* active, int row) {
  const int rank = blockIdx.x % g.cluster;         // the CTA's slab
  const long long tile = (long long)row * g.n_tiles + blockIdx.x / g.cluster;
  if (g.skip_inactive && active[tile] == 0) return;   // uniform per cluster

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int span[2 * MWD_MAX_T];               // clipped y0, y1 per tau
  __shared__ unsigned long long xchg;               // bit tau: push halos
  __shared__ Op sop;                                // the op, read per row
  const int R = g.radius, T = g.t_steps, nf = g.n_f, D = g.depth;
  const int Dc = g.cdepth, wy = g.wy, wx = g.wx, plane = wy * wx;
  const int ring = D * plane;                       // one parity ring
  const int cplane = g.d_w * g.slab, cring = Dc * cplane;
  int* tab = reinterpret_cast<int*>(smem);          // [D][n_taps]
  S* win = reinterpret_cast<S*>(smem + g.tab_bytes);   // [2][D][wy][wx]
  S* cwin = win + 2 * ring;                         // [A][Dc][d_w][slab]
  S* left = nullptr;                                // neighbours' windows
  S* right = nullptr;
  if (g.exchange) {
    cg::cluster_group cluster = cg::this_cluster();
    if (rank > 0) left = cluster.map_shared_rank(win, rank - 1);
    if (rank + 1 < g.cluster) right = cluster.map_shared_rank(win, rank + 1);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int x0 = g.lo_x + rank * g.slab;            // first own column
  const int w = max(min(g.slab, g.hi_x - x0), 0);   // own columns
  const int xw = w + 2 * R;                         // columns streamed in
  const int w0 = w0t[tile];                         // window's first y
  const int yo = w0 + R;                            // first own y
  const long long b = blockIdx.y;
  S* const grid_e = buf_e + b * g.grid_elems;
  S* const grid_o = buf_o + b * g.grid_elems;
  const S* cf = coeff ? coeff + b * g.n_arrays * g.coeff_elems : nullptr;

  for (int i = threadIdx.x; !kStar && i < D * g.n_taps; i += blockDim.x) {
    const int s = i / g.n_taps, t = i % g.n_taps;
    const int s2 = ((s + td.dz[t]) % D + D) % D;
    tab[i] = (s2 - s) * plane + td.dy[t] * wx + td.dx[t];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    span[t] = max(y0t[tile * T + t], g.lo_y);
    span[MWD_MAX_T + t] = min(y1t[tile * T + t], g.hi_y);
  }
  for (int i = threadIdx.x; i < (int)(sizeof(Op) / 4); i += blockDim.x)
    reinterpret_cast<int*>(&sop)[i] = reinterpret_cast<const int*>(&op)[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    // update tau pushes its halos iff a later update of the tile reads the
    // parity it writes: one an odd number of updates later (DESIGN.md
    // sec. 3: update tau+1 reads tau's rows, in this step and the next)
    unsigned long long bits = 0, later[2] = {0, 0};
    for (int t = T - 1; t >= 0; --t) {
      const bool cells = span[MWD_MAX_T + t] > span[t] && g.hi_x > g.lo_x;
      if (cells && later[(t + 1) & 1]) bits |= 1ULL << t;
      if (cells) later[t & 1] = 1;
    }
    xchg = g.exchange ? bits : 0;   // the launcher's rule over all tiles
  }

  // parity rows [j*nf, (j+1)*nf) and coefficient rows R lower, `ahead`
  // steps before their use, into ring slots whose rows are dead; a warp
  // takes one y row of the window at a time
  auto load = [&](int j) {
    if (j >= g.n_j) return;
    const int slot0 = j * nf % D;
    for (int y = warp; y < wy; y += n_warps) {
      const long long yoff = (long long)(w0 + y) * g.sy + (x0 - R);
      for (int zz = 0, slot = slot0; zz < nf;
           ++zz, slot = slot + 1 < D ? slot + 1 : 0) {
        const long long zoff = (long long)(j * nf + zz) * g.sz + yoff;
        S* dst = win + slot * plane + y * wx;
        copy_row(dst, grid_e + zoff, xw, lane);
        copy_row(dst + ring, grid_o + zoff, xw, lane);
      }
    }
    if (kStage) {
      const int z0 = j * nf - R;
      for (int y = warp; y < g.d_w; y += n_warps) {
        const int yu = yo + y - g.py;
        if (yu < 0 || yu >= g.ny) continue;
        for (int zz = 0; zz < nf; ++zz) {
          const int zu = z0 + zz - g.pz;
          if (zu < 0 || zu >= g.nz) continue;
          const S* src = cf + zu * g.csz + yu * g.csy + (x0 - g.px);
          S* dst = cwin + (z0 + zz) % Dc * cplane + y * g.slab;
          for (int a = 0; a < g.n_arrays; ++a)
            copy_row(dst + a * cring, src + a * g.coeff_elems, w, lane);
        }
      }
    } else if (cf != nullptr) {
      // the same coefficient rows, read in place later: into L2 for now
      const int z0 = j * nf - R;
      constexpr int LINE = 128 / sizeof(S);
      for (int y = warp; y < g.d_w; y += n_warps) {
        const int yu = yo + y - g.py;
        if (yu < 0 || yu >= g.ny) continue;
        for (int zz = 0; zz < nf; ++zz) {
          const int zu = z0 + zz - g.pz;
          if (zu < 0 || zu >= g.nz) continue;
          const S* src = cf + zu * g.csz + yu * g.csy + (x0 - g.px);
          const int lines = (w + LINE - 1) / LINE;
          for (int i = lane; i < g.n_arrays * lines; i += 32)
            asm volatile("prefetch.global.L2 [%0];\n" ::
                         "l"(src + (i / lines) * g.coeff_elems
                             + (i % lines) * LINE));
        }
      }
    }
  };

  for (int s = 0; s < g.ahead; ++s) {
    load(s);
    cp_async_commit();
  }
  cp_async_wait(g.ahead - 1);
  if (g.exchange)
    cluster_sync();     // slab 0 and the tables in place, cluster running
  else
    __syncthreads();
  const bool any_xchg = xchg != 0;

  const int p0 = parity[row];
  const long long cstride = kStage ? cring : g.coeff_elems;
  for (int j = 0; j < g.n_j; ++j) {
    load(j + g.ahead);
    cp_async_commit();
    for (int tau = 0; tau < T; ++tau) {
      const int zs = j * nf - (tau + 1) * R;
      const int z0 = max(zs, g.lo_z), z1 = min(zs + nf, g.hi_z);
      const int ya = span[tau], yb = span[MWD_MAX_T + tau];
      const bool live = z1 > z0 && yb > ya && g.hi_x > g.lo_x;
      const bool push = (xchg >> tau) & 1;
      if (live) {
        const int pp = (p0 + tau) & 1, nyr = yb - ya;
        const S* src = win + pp * ring;
        S* dst = win + (1 - pp) * ring;
        const int slot0 = z0 % D, cslot0 = z0 % Dc;
        for (int rr = warp; rr < (z1 - z0) * nyr; rr += n_warps) {
          int zz = 0, y = ya + rr;              // rr = zz * nyr + (y - ya)
          while (y >= yb) {
            y -= nyr;
            ++zz;
          }
          const int z = z0 + zz;
          const int slot = slot0 + zz < D ? slot0 + zz : slot0 + zz - D;
          const auto taps = row_taps<kStar>(tab + slot * g.n_taps, slot, D,
                                            plane, wx);
          const int base = slot * plane + (y - w0) * wx + R;
          const int cslot = cslot0 + zz < Dc ? cslot0 + zz : cslot0 + zz - Dc;
          const S* crow = kStage
              ? cwin + cslot * cplane + (y - yo) * g.slab
              : cf ? cf + (z - g.pz) * g.csz + (y - g.py) * g.csy
                     + (x0 - g.px)
                   : nullptr;
          if (!kStage && crow != nullptr) {   // this row's coefficients
            constexpr int LINE = 128 / sizeof(S);
            const int lines = (w + LINE - 1) / LINE;
            for (int i = lane; i < g.n_arrays * lines; i += 32)
              asm volatile("prefetch.global.L1 [%0];\n" ::
                           "l"(crow + (i / lines) * g.coeff_elems
                               + (i % lines) * LINE));
          }
          for (int xb = 0; xb < w; xb += 32 * MWD_CELLS) {
            const int x = xb + lane;
            const int n = min(MWD_CELLS, (w - x + 31) >> 5);
            if (n <= 0) continue;
            const int c = base + x;
            update_cell<S, A, MWD_CELLS, kHoist>(src + c, taps, dst + c,
                                                 dst + c, crow, x, cstride,
                                                 sop, 32, n);
            for (int v = 0; push && v < n; ++v) {     // halo pushes
              const int xv = x + 32 * v, cv = c + 32 * v;
              const int off = (1 - pp) * ring + cv;
              if (left != nullptr && xv < R) left[off + g.slab] = dst[cv];
              if (right != nullptr && xv >= w - R)
                right[off - g.slab] = dst[cv];
            }
          }
        }
      }
      if (tau == T - 1) {
        cp_async_wait(g.ahead - 1);   // slab j+1 in before the barrier
        if (any_xchg)
          cluster_sync();
        else
          __syncthreads();
      } else if (live && push) {
        cluster_sync();
      } else if (live) {
        __syncthreads();
      }
    }
    if (j >= g.d_w / nf) {        // rows [j*nf - d_w, +nf) are final
      const int zf = j * nf - g.d_w;
      for (int y = warp; y < g.d_w; y += n_warps) {
        const long long yoff = (long long)(yo + y) * g.sy + x0;
        for (int zz = 0, slot = zf % D; zz < nf;
             ++zz, slot = slot + 1 < D ? slot + 1 : 0) {
          const long long goff = (zf + zz) * g.sz + yoff;
          const S* in = win + slot * plane + (y + R) * wx + R;
          for (int x = lane; x < w; x += 32) {
            grid_e[goff + x] = in[x];
            grid_o[goff + x] = in[ring + x];
          }
        }
      }
      __syncthreads();            // the next step's loads reuse these slots
    }
  }
}

// `iters` cluster barriers (arrive.release, wait.acquire) with nothing
// between them: the cost of K1's per-update barrier at a cluster size.
__global__ void cluster_probe_kernel(int iters) {
  for (int i = 0; i < iters; ++i) cluster_sync();
}

// A launch configuration for one problem: cluster size, slab width,
// whether the coefficients are staged, and the shared memory it takes.
struct Plan {
  int cluster, slab, stage, threads, smem, max_clusters, hoist, static_smem;
};

// The star instances: f32 and f64 streams in their own precision, every
// layout, coefficients staged or not (a star update issues every group's
// coefficient loads together, so `hoist` does not select among them).
template <typename S, typename A>
constexpr bool kStarBuilt = std::is_same<S, A>::value
    && (std::is_same<S, float>::value || std::is_same<S, double>::value);

template <typename S, typename A, bool kStage>
static void* star_kernel(int star) {
  switch (star) {
    case 1: return (void*)mwd_row_kernel<S, A, kStage, 0, 1>;
    case 2: return (void*)mwd_row_kernel<S, A, kStage, 0, 2>;
    case 3: return (void*)mwd_row_kernel<S, A, kStage, 0, 3>;
    case 4: return (void*)mwd_row_kernel<S, A, kStage, 0, 4>;
    case 5: return (void*)mwd_row_kernel<S, A, kStage, 0, 5>;
    case 6: return (void*)mwd_row_kernel<S, A, kStage, 0, 6>;
    case 7: return (void*)mwd_row_kernel<S, A, kStage, 0, 7>;
  }
  return nullptr;
}

// The kernel instance for a plan: coefficients staged or not, and the
// array-coefficient groups whose loads are hoisted (0, 8 or 16: the fewest
// that cover the op, so an op without them keeps its registers); or, for
// an op of a star layout (`star` > 0), that layout's instance. nullptr
// where no such instance is built.
template <typename S, typename A>
static void* kernel_for(int stage, int hoist, int star) {
  if constexpr (kStarBuilt<S, A>) {
    if (star)
      return stage ? star_kernel<S, A, true>(star)
                   : star_kernel<S, A, false>(star);
  }
  if (star) return nullptr;
  if (stage) {
    if (hoist == 0) return (void*)mwd_row_kernel<S, A, true, 0, 0>;
    if (hoist == 8) return (void*)mwd_row_kernel<S, A, true, 8, 0>;
    return (void*)mwd_row_kernel<S, A, true, 16, 0>;
  }
  if (hoist == 0) return (void*)mwd_row_kernel<S, A, false, 0, 0>;
  if (hoist == 8) return (void*)mwd_row_kernel<S, A, false, 8, 0>;
  return (void*)mwd_row_kernel<S, A, false, 16, 0>;
}

static int round16(long long v) { return (int)((v + 15) & ~15LL); }

// Dynamic shared memory for a slab width; fills the ring fields of g.
static long long smem_bytes(Geo& g, int slab, int stage, int elem) {
  const int R = g.radius;
  g.ahead = g.t_steps >= 4 ? 1 : 2;    // keep >= 4 updates over a load
  g.depth = (g.ahead + 1) * g.n_f + g.t_steps * R + R;
  g.cdepth = (g.ahead + 1) * g.n_f + R * (g.t_steps - 1);
  g.wy = g.d_w + 2 * R;
  const int e = 16 / elem;                   // elements per 16 bytes
  g.wx = (slab + 2 * R + e - 1) / e * e;     // rows start 16-byte aligned
  g.tab_bytes = round16((long long)g.depth * g.n_taps * 4);
  long long bytes = g.tab_bytes
      + (long long)round16(2LL * g.depth * g.wy * g.wx * elem);
  if (stage)
    bytes += (long long)g.n_arrays * g.cdepth * g.d_w * slab * elem;
  return bytes;
}

// Blocks of `bytes` dynamic shared memory that fit one SM beside the static
// shared memory and the 1 KB the runtime reserves per block.
static int per_sm(long long bytes, int smem_sm) {
  return (int)(smem_sm / (bytes + (long long)sizeof(Op) + 2048));
}

// Slab width, cluster size, coefficient staging and block size from the
// interior x width, the dtype and the op: aim for MWD_SLAB_TARGET columns
// per CTA (a portable cluster at nx = 512), taking the smallest cluster
// whose parity rings fit one block's shared memory beside the instance's
// static shared memory (`static_bytes[stage]`, the runtime's own count:
// the opt-in limit holds both); stage the coefficient
// streams only where that keeps as many blocks per SM as reading them in
// place (latency hides behind more resident blocks better than behind a
// staged ring); 256 threads where two or more blocks share an SM, else 512.
// A cluster size the caller asks for (g.cluster_req, the paper's thread
// group size) is the only one tried: E_CLUSTER_SIZE where the slab
// rounding gives another count of CTAs (or slabs narrower than R), E_SMEM
// where its rings do not fit.
static int choose(Geo& g, int elem, int smem_max, int smem_sm,
                  const int static_bytes[2], Plan& p) {
  const int nxr = max(g.hi_x - g.lo_x, 0);
  const int c_min = g.cluster_req ? g.cluster_req
      : max(1, (nxr + MWD_SLAB_TARGET - 1) / MWD_SLAB_TARGET);
  const int c_max = g.cluster_req ? g.cluster_req : MWD_MAX_CLUSTER;
  const int e = 16 / elem;            // slabs start 16-byte aligned
  for (int c = c_min; c <= c_max; ++c) {
    const int slab = max((nxr + c - 1) / c + e - 1, e) / e * e;
    const int cl = max(1, (nxr + slab - 1) / slab);
    if (g.cluster_req && (cl != c || (cl > 1 && slab < g.radius)))
      return E_CLUSTER_SIZE;
    if (cl > MWD_MAX_CLUSTER || (cl > 1 && slab < g.radius)) break;
    const long long plain = smem_bytes(g, slab, 0, elem);
    const long long staged = g.n_arrays ? smem_bytes(g, slab, 1, elem) : -1;
    const int stage = staged >= 0 && staged + static_bytes[1] <= smem_max
        && per_sm(staged, smem_sm) >= per_sm(plain, smem_sm);
    const long long bytes = stage ? staged : plain;
    if (bytes + static_bytes[stage] > smem_max) continue;
    p.threads = per_sm(bytes, smem_sm) >= 2 ? 256 : 512;
    p.cluster = cl;
    p.slab = slab;
    p.stage = stage;
    p.smem = (int)smem_bytes(g, slab, stage, elem);   // sets g's rings
    p.static_smem = static_bytes[stage];
    g.cluster = cl;
    g.slab = slab;
    return 0;
  }
  return E_SMEM;
}

template <typename S, typename A>
static int plan_launch(Geo& g, int star, int device, Plan& p, void** fn) {
  int smem_max = 0, smem_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return (int)err;
  p.hoist = g.n_array_groups == 0 ? 0 : g.n_array_groups <= 8 ? 8 : 16;
  if (kernel_for<S, A>(0, p.hoist, star) == nullptr) return E_TYPES;
  int static_bytes[2];
  for (int stage = 0; stage < 2; ++stage) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel_for<S, A>(stage, p.hoist, star));
    if (err != cudaSuccess) return (int)err;
    static_bytes[stage] = (int)fa.sharedSizeBytes;
  }
  const int bad = choose(g, (int)sizeof(S), smem_max, smem_sm, static_bytes,
                         p);
  if (bad) return bad;
  void* kernel = kernel_for<S, A>(p.stage, p.hoist, star);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return (int)err;
  if (g.exchange && p.cluster > MWD_PORTABLE_CLUSTER) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.exchange ? p.cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(g.n_tiles * p.cluster, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&p.max_clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (p.max_clusters < 1) return E_CLUSTER;
  *fn = kernel;
  return 0;
}

template <typename S, typename A>
static int launch_rows(void* buf_e, void* buf_o, const void* coeff, Geo g,
                       const Op& op, const TapDelta& td, int star,
                       const int* tables, int n_rows, int row_begin,
                       int row_end, int batch, int device,
                       cudaStream_t stream) {
  Plan p;
  void* fn = nullptr;
  const int bad = plan_launch<S, A>(g, star, device, p, &fn);
  if (bad) return bad;
  const long long n_tab = (long long)n_rows * g.n_tiles;
  const int* parity = tables;
  const int* w0t = parity + n_rows;
  const int* active = w0t + n_tab;
  const int* y0t = active + n_tab;
  const int* y1t = y0t + n_tab * g.t_steps;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.exchange ? p.cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(g.n_tiles * p.cluster, batch, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  S* be = static_cast<S*>(buf_e);
  S* bo = static_cast<S*>(buf_o);
  const S* cf = static_cast<const S*>(coeff);
  Op op_arg = op;
  TapDelta td_arg = td;
  int row = 0;
  void* args[] = {&be, &bo, &cf, &g, &op_arg, &td_arg, &parity, &w0t,
                  &y0t, &y1t, &active, &row};
  for (row = row_begin; row < row_end; ++row) {
    cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// geo[27]: grid_elems, sz, sy, n_arrays, n_j, n_f, radius, t_steps, n_tiles,
//          lo_z, hi_z, lo_y, hi_y, lo_x, hi_x, skip_inactive, nz, ny, nx,
//          pz, py, px, d_w, n_taps, n_array_groups, cluster_req, exchange
static int read_geo(const long long* geo, Geo& g) {
  g = Geo{};
  g.grid_elems = geo[0]; g.sz = geo[1]; g.sy = geo[2];
  g.n_arrays = (int)geo[3]; g.n_j = (int)geo[4]; g.n_f = (int)geo[5];
  g.radius = (int)geo[6]; g.t_steps = (int)geo[7]; g.n_tiles = (int)geo[8];
  g.lo_z = (int)geo[9]; g.hi_z = (int)geo[10]; g.lo_y = (int)geo[11];
  g.hi_y = (int)geo[12]; g.lo_x = (int)geo[13]; g.hi_x = (int)geo[14];
  g.skip_inactive = (int)geo[15];
  g.nz = (int)geo[16]; g.ny = (int)geo[17];
  const long long nx = geo[18];
  g.pz = (int)geo[19]; g.py = (int)geo[20]; g.px = (int)geo[21];
  g.d_w = (int)geo[22];
  g.n_taps = (int)geo[23]; g.n_array_groups = (int)geo[24];
  g.cluster_req = (int)geo[25];
  g.exchange = (int)geo[26];
  g.csy = nx;
  g.csz = (long long)g.ny * nx;
  g.coeff_elems = (long long)g.nz * g.csz;
  if (g.n_tiles < 1 || g.n_f < 1 || g.radius < 1 || 2 * g.radius > 32
      || g.t_steps < 1 || g.t_steps > MWD_MAX_T || g.d_w % g.n_f
      || g.n_taps < 1 || g.n_taps > STENCIL_MAX_TAPS
      || g.cluster_req < 0 || g.cluster_req > MWD_MAX_CLUSTER)
    return E_GEOMETRY;
  return 0;
}

#define MWD_DISPATCH(CALL)                                          \
  if (stream_type == acc_type) {                                    \
    switch (stream_type) {                                          \
      case T_F32: return CALL(float, float);                        \
      case T_F64: return CALL(double, double);                      \
      case T_BF16: return CALL(__nv_bfloat16, __nv_bfloat16);       \
      case T_F16: return CALL(__half, __half);                      \
    }                                                               \
  } else if (acc_type == T_F32) {                                   \
    switch (stream_type) {                                          \
      case T_BF16: return CALL(__nv_bfloat16, float);               \
      case T_F16: return CALL(__half, float);                       \
    }                                                               \
  }                                                                 \
  return E_TYPES;

extern "C" {

// Launch rows [row_begin, row_end) of the compiled schedule on `stream`.
//   geo[27]     see read_geo
//   taps[n]     linear tap offsets in group order (padded grid layout)
//   taps3[3n]   (dz, dy, dx) of the same taps
//   groups[3*G+2]  (count, kind, slot) per group, then (scale_kind, slot)
//   values[G+1] const value per group (0 for array groups), then the scale's
//   star        0, or the op's star layout (1..STAR_LAYOUTS, `Star`): its
//               instance runs (f32 and f64 streams in their own precision
//               only, E_TYPES otherwise; E_OP where the op's taps, group
//               sizes or coefficient kinds are not the layout's)
//   tables      parity[n_rows], w0[n_rows*n_tiles], active[n_rows*n_tiles],
//               y0[n_rows*n_tiles*T], y1[...], all padded y
// Returns 0, a negative launcher error, or the cudaError_t of a launch.
int mwd_rows(int stream_type, int acc_type, void* buf_e, void* buf_o,
             const void* coeff, const long long* geo, const long long* taps,
             const int* taps3, int n_taps, const int* groups,
             const double* values, int n_groups, int time_order, int star,
             const int* tables, int n_rows, int row_begin, int row_end,
             int batch, int device, void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  Geo g;
  if (read_geo(geo, g) || g.n_taps != n_taps
      || batch < 1 || batch > 65535 || row_begin < 0 || row_end > n_rows)
    return E_GEOMETRY;
  TapDelta td;
  if (make_tap_delta(td, taps3, n_taps, g.radius)) return E_OP;
  if (star && !star_matches(star, op, td, n_taps)) return E_OP;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MWD_LAUNCH(S, A)                                                  \
  launch_rows<S, A>(buf_e, buf_o, coeff, g, op, td, star, tables, n_rows, \
                    row_begin, row_end, batch, device, s)
  MWD_DISPATCH(MWD_LAUNCH)
#undef MWD_LAUNCH
}

// The launch configuration mwd_rows would use for `geo` and `star`, without
// launching: out[11] = cluster (CTAs per tile), slab, stage, threads,
// dynamic shared bytes per CTA, max active clusters, parity ring depth,
// coefficient ring depth, hoisted coefficient groups, exchange (launched as
// clusters), static shared bytes of the chosen instance.
int mwd_config(int stream_type, int acc_type, const long long* geo,
               int star, int device, int* out) {
  Geo g;
  if (read_geo(geo, g)) return E_GEOMETRY;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  void* fn = nullptr;
  int rc = 0;
#define MWD_PLAN(S, A)                                                      \
  (rc = plan_launch<S, A>(g, star, device, p, &fn),                         \
   rc ? rc : (out[0] = p.cluster, out[1] = p.slab, out[2] = p.stage,        \
              out[3] = p.threads, out[4] = p.smem, out[5] = p.max_clusters, \
              out[6] = g.depth, out[7] = g.cdepth, out[8] = p.hoist,        \
              out[9] = g.exchange, out[10] = p.static_smem, 0))
  MWD_DISPATCH(MWD_PLAN)
#undef MWD_PLAN
}

// Run `iters` cluster barriers in `n_clusters` clusters of `cluster` CTAs of
// `threads` threads on `stream` (timed by the caller around the launch).
int mwd_cluster_probe(int cluster, int n_clusters, int threads, int iters,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > MWD_MAX_CLUSTER || n_clusters < 1
      || threads < 32 || threads > MWD_MAX_THREADS)
    return E_GEOMETRY;
  if (cluster > MWD_PORTABLE_CLUSTER) {
    err = cudaFuncSetAttribute(
        cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster * n_clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, iters);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

const char* mwd_error_string(int code) {
  switch (code) {
    case E_CLUSTER:
      return "the thread-block cluster does not fit on the device";
    case E_SMEM:
      return "no slab width fits the rings beside the static shared memory";
    case E_CLUSTER_SIZE:
      return "the requested cluster size does not split the x range into "
             "that many slabs";
  }
  return stencil_error_string(code);
}

}  // extern "C"
