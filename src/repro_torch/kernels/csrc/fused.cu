// K3 on Hopper: one ghost-zone pass of temporal blocking (t_block time
// steps on each block, its halo recomputed redundantly), written by hand in
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil_fused.py::_kernel
// (Pallas grid over (z, y) blocks, each program copying a
// (bz+2g, by+2g, nx+2g) window, g = R*t_block, of every edge-padded stream
// into VMEM, running t_block sweeps there with the Dirichlet frame restored
// after each, and writing the un-haloed centre of both levels).
//
// What bounds it on this card. In bytes, the window: per tile, cur over
// the level-0 box (the centre widened by g on every side), prev and the
// coefficient streams over the level-1 box, and both centres written
// (stencil_fused.window_bytes); the compulsory bytes, every stream once,
// are the lower bound. In operations, the redundant halo updates: at the
// 25-point ops 4.4x the centre's at bz = by = 16, t_block = 4, bx = 32, each
// 25 taps from shared memory or L1, so shared-memory and L1 load bandwidth
// bound those ops long before HBM does. Measured on an H100 (PERF.md), the
// kernel runs far above both: the latency of an update's loads, at the
// residency the rings leave, sets its pace.
//
// Design: every intermediate level stays on chip ("3.5-D" blocking).
//   * one launch per pass on the caller's stream; one CTA per (z chunk of
//     bz, y tile, x tile of bx) with x-ghosts. The TPU kept x whole; a
//     whole x row does not fit shared memory here, so each CTA recomputes
//     its g-wide x halo exactly as z and y already do. No CTA reads
//     another's work: no cluster, no grid barrier (a cluster barrier costs
//     0.64-0.68 us on an H100, and a per-plane chain of them is what limits
//     K1). The y tile is the caller's block of by rows, or, where the rings
//     of a block that tall fit no layout, the block split into sub-tiles of
//     ty rows (each cell's value does not depend on its block, so the bits
//     do not change). The host picks bx, ty, the threads, the layout, the
//     planes per step and the instance (stencil_fused.choose_tile) and
//     hands the ring layout over in `geo`; a pass of more steps than any
//     layout holds, it runs as several launches (stencil_fused.launch_steps);
//   * the CTA walks its chunk's planes k = cz - g ... cz + bz + g - 1, P
//     planes a step (P = 1, or 2 with level 0 in place and no hoisted
//     coefficient loads). Level s = 0 ... T-1 keeps a ring of
//     2R + P planes over its own (y, x) box, the centre widened by (T - s)R,
//     clipped to the grid; level 0 (cur, streamed in with cp.async `ahead`
//     steps early) keeps 2R + P(1 + ahead). At the step of planes
//     [k, k + P) the CTA computes level s at planes [k - sR, k - sR + P)
//     for s = 1 ... T, one block barrier after each level: level s reads
//     level s-1's planes k - (s+1)R ... k - (s-1)R + P - 1, the last P of
//     them made earlier in the step. A 2nd-order op also reads level s-2 at
//     the cell, the oldest planes of that ring (level -1 is the prev input,
//     read at the cell);
//   * level T goes straight to out_cur over the centre, and the centre of
//     level T-1 to out_prev from its ring in the step that makes it (T = 1:
//     cur's centre is copied), so both outputs are complete grids, frame
//     included, with no second pass over memory and no host clone;
//   * a ring wraps in z and each level's box has its own row width, so a
//     cell's taps are src[tab[slot][t]], with one offset table per (ring,
//     slot) built once per CTA, as are the rings' and levels' constants;
//     a thread walks fixed (y, x) cells of the plane box with an increment,
//     and a slot index costs a multiply, no division;
//   * the coefficient streams are read only at the updated cell, in place
//     through the read-only path (a plane serves levels 1 ... T at steps R
//     apart). A ring of them, staged where it kept as many CTAs per SM as
//     K1's rule has it, measured slower (PERF.md), so K3 keeps none;
//   * a second layout reads level 0 in place from global memory (through
//     L1/L2) and keeps only levels 1 ... T-1 in rings: where the rings of
//     every level do not fit (f64 at R = 4, t_block = 4), and where it runs
//     faster (ops without coefficient streams; the 25-point ops, at a wider
//     x tile). At 512^3, f32 and the defaults the host picks x tile 64,
//     level 0 in place, 4 CTAs of 256 threads per SM, one plane a step at
//     7pt-const; 32, all levels in rings, 4 x 256, one plane at 7pt-var; 32,
//     level 0 in place, one CTA of 1024 threads, two planes a step at
//     25pt-const and one at 25pt-var (chip_smoke.py --sweep-k3, PERF.md).
//
// Why no valid centre cell reads a stale or clipped cell. Boxes are clipped
// to the grid instead of padded: a cell outside the grid is a frame cell of
// the reference, and no interior cell's tap leaves the grid, so none is ever
// needed. A frame cell of any level takes cur's value, as the reference
// restores the frame after every step (read from the level-0 ring while it
// still holds the plane, s <= 2, else from cur in global memory). An
// interior cell of level s in its box reads level s-1 within R of it, which
// lies in level s-1's box (R wider) and, being inside the grid, was
// computed; in z, level s-1's ring holds exactly the 2R + P planes around
// the P it serves, and the slots a level overwrites in a step held planes
// last read in the step before, ahead of the barrier that opens this one.
// The level-0 loads issued after that barrier overwrite planes
// k - 2R - P ... k - 2R - 1, last read in the step before as well. Ring
// slots follow the plane index (k mod depth), so a chunk at the grid's
// edge, with a shorter pipeline, and a y sub-tile address them alike.
//
// Arithmetic: `update_cell<S, S, V, H>` of stencil_cell.cuh in the stream
// type, as the reference has no accumulator option. The instances: V = 2
// cells a thread with no hoisted coefficient loads (H = 0, ops without
// array coefficients), V = 1 with the loads of H = 8 or 16 groups hoisted
// (ops with them); the order of operations, and so the bits, is the same
// for every V and H. Built with -fmad=false, so it agrees bit for bit with
// the plain PyTorch version (repro_torch.core.ir); rings hold the stream
// type, since the reference rounds every level to it.

#include "async_copy.cuh"
#include "stencil_cell.cuh"

#define FUSED_MAX_THREADS 1024
// steps one launch takes (the per-CTA tables); no layout holds this many
// at any op, so the host's split of a longer pass never reaches it
#define FUSED_MAX_LEVELS 32
#define FUSED_STATIC_SMEM 2560  // bytes of the per-CTA tables (static)
#define FUSED_MAX_PLANES 2      // planes a step
// cells a thread updates at once: two where no coefficient load is hoisted,
// else one, so that every instance fits 64 registers (measured: two cells
// with hoisted loads spill or, given more registers, lose residency)
#define FUSED_CELLS(hoist) ((hoist) == 0 ? 2 : 1)

// One z-ring of planes in shared memory (stencil_fused.Ring): plane k in
// slot k % depth; cell (y, x) of the CTA whose centre starts at (cy, cx) at
// (y - (cy - my)) * width + x - (cx - mx); `base` in bytes; `tab` the first
// int of its per-slot tap table.
struct Ring {
  int mx, my, width, height, depth, base, tab;
};

struct FusedGeo {
  long long sz;           // grid z stride, ny*nx (y stride nx, x contiguous)
  long long grid_elems;   // one grid, nz*ny*nx
  int nz, ny, nx, bz, by, bx, ty, radius, t_block, threads, planes;
  int n_arrays, n_taps, smem_bytes;
  int ahead;              // steps of planes loaded ahead (1 or 2)
  int hoist;              // coefficient loads hoisted: 0, 8 or 16 groups
  Ring ring[FUSED_MAX_LEVELS];   // level s < t_block (level 0: cur)
};

// Per-CTA tables, built once so that a step costs each thread a few shared
// loads per level and no division. Ring s (level s < t_block): `base` the
// element index of its slot 0 shifted so that cell (y, x) sits at base +
// slot * plane + y * width + x, and `inv` a multiplier that divides by its
// depth (quot). Level s (1 ... t_block): its planes [zlo, zhi), its box
// [y0, y1) x [x0, x1), h the box's width over FUSED_CELLS, ry the rows a
// block-wide step of the walk advances, and `inv` a multiplier that
// divides by h.
struct RingRow {
  int base, width, plane, depth, tab;
  unsigned long long inv;
};
struct LevelRow {
  int zlo, zhi, y0, y1, x0, x1, h, ry;
  unsigned long long inv;
};
static_assert(sizeof(RingRow) * (FUSED_MAX_LEVELS + 1)
              + sizeof(LevelRow) * (FUSED_MAX_LEVELS + 1)
              <= FUSED_STATIC_SMEM, "FUSED_STATIC_SMEM too small");

// ceil(2^32 / d): quot(a, inverse(d)) == a / d for 0 <= a, d < 2^16
__device__ __forceinline__ unsigned long long inverse(int d) {
  return (0x100000000ULL + d - 1) / d;
}
__device__ __forceinline__ int quot(int a, unsigned long long inv) {
  return (int)(((unsigned long long)a * inv) >> 32);
}

// Copy rows [y0, y1) and columns [x0, x1) of one plane of `src` (grid
// layout) to `dst`, where cell (y, x) goes to dst[y * width + x], a warp
// per row (copy_row: 16 bytes at a time where both ends are aligned).
template <typename S>
__device__ __forceinline__ void load_plane(S* dst, int width, const S* src,
                                           int nx, int y0, int y1, int x0,
                                           int x1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = y0 + warp; y < y1; y += blockDim.x >> 5)
    copy_row(dst + y * width + x0, src + (long long)y * nx + x0, x1 - x0,
             lane);
}

// One pass. Grid (x tiles, y blocks x their sub-tiles, z chunks);
// `kInPlace`: level 0 is read in place from cur (no level-0 ring);
// `kHoist`: the array-coefficient groups whose loads update_cell issues
// together; `kPlanes`: planes a step, a template argument so that one
// plane a step compiles to a single pass over the level (measured: a loop
// whose trip count is known only at run time spilled in more instances
// and ran 25pt-var slower). Two planes a step are built only with level 0
// in place and no hoisted loads, where they ran faster (with 16 groups'
// loads hoisted they spill and ran slower). Every instance keeps to 64
// registers a thread, so 1024 threads fill an SM's registers whatever the
// split into CTAs.
template <typename S, bool kInPlace, int kHoist, int kPlanes>
__global__ void __launch_bounds__(FUSED_MAX_THREADS, 1)
fused_kernel(S* __restrict__ out_cur, S* __restrict__ out_prev,
             const S* __restrict__ cur, const S* __restrict__ prev,
             const S* __restrict__ coeff, __grid_constant__ const FusedGeo g,
             __grid_constant__ const Op op,
             __grid_constant__ const TapDelta td) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RingRow rr[FUSED_MAX_LEVELS + 1];
  __shared__ LevelRow lr[FUSED_MAX_LEVELS + 1];
  int* tab = reinterpret_cast<int*>(smem);
  S* const sm = reinterpret_cast<S*>(smem);
  const int R = g.radius, T = g.t_block, nthr = blockDim.x;
  constexpr int P = kPlanes;
  // y: sub-tile i of the caller's block j, clipped to the block and grid
  const int n_sub = (g.by + g.ty - 1) / g.ty;
  const int yb = blockIdx.y / n_sub, ys = blockIdx.y - yb * n_sub;
  const int cy = yb * g.by + ys * g.ty;
  const int ey = min(min(cy + g.ty, yb * g.by + g.by), g.ny);
  if (cy >= ey) return;                      // past the grid's last row
  const int cx = blockIdx.x * g.bx, cz = blockIdx.z * g.bz;
  const int ez = min(cz + g.bz, g.nz);
  const int ex = min(cx + g.bx, g.nx);       // end of the centre
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = nthr >> 5;

  for (int s = kInPlace ? 1 : 0; s < T; ++s) {
    const Ring& q = g.ring[s];
    for (int i = threadIdx.x; i < q.depth * g.n_taps; i += nthr) {
      const int j = i / g.n_taps, t = i - j * g.n_taps;
      const int j2 = ((j + td.dz[t]) % q.depth + q.depth) % q.depth;
      tab[q.tab + i] = (j2 - j) * q.width * q.height + td.dy[t] * q.width
          + td.dx[t];
    }
  }
  for (int r = threadIdx.x; r < T; r += nthr) {
    const Ring& q = g.ring[r];
    RingRow row;
    row.base = q.base / (int)sizeof(S) - (cy - q.my) * q.width
        - (cx - q.mx);
    row.width = q.width;
    row.plane = q.width * q.height;
    row.depth = q.depth;
    row.tab = q.tab;
    row.inv = q.depth > 0 ? inverse(q.depth) : 0;
    rr[r] = row;
  }
  for (int s = threadIdx.x + 1; s <= T; s += nthr) {
    const int m = (T - s) * R;
    LevelRow row;
    row.zlo = max(cz - m, 0);
    row.zhi = min(ez + m, g.nz);
    row.y0 = max(cy - m, 0);
    row.y1 = min(ey + m, g.ny);
    row.x0 = max(cx - m, 0);
    row.x1 = min(ex + m, g.nx);
    row.h = (row.x1 - row.x0 + FUSED_CELLS(kHoist) - 1)
          / FUSED_CELLS(kHoist);
    row.ry = nthr / row.h;
    row.inv = inverse(row.h);
    lr[s] = row;
  }
  __syncthreads();

  // slot p of ring r: cell (y, x) at [y * width + x] of the pointer
  auto ring = [&](int r, int p) {
    const RingRow& q = rr[r];
    return sm + q.base + (p - q.depth * quot(p, q.inv)) * q.plane;
  };
  // planes of level 0, and the rows and columns its ring loads
  const int z0 = max(cz - T * R, 0), z0e = min(ez + T * R, g.nz);
  const Ring& q0 = g.ring[0];
  auto load = [&](int k) {                // cur planes k ... k + P - 1
    if (!kInPlace)
      for (int kk = max(k, z0); kk < min(k + P, z0e); ++kk)
        load_plane(ring(0, kk), q0.width, cur + kk * g.sz, g.nx,
                   max(cy - q0.my, 0), min(cy - q0.my + q0.height, g.ny),
                   max(cx - q0.mx, 0), min(cx - q0.mx + q0.width, g.nx));
    cp_async_commit();
  };

  const int k_end = ez + T * R;       // level T's last plane is ez - 1
  for (int a = 0; a < g.ahead; ++a) load(z0 + a * P);
  for (int k = z0; k < k_end; k += P) {
    cp_async_wait(g.ahead - 1);
    __syncthreads();                  // planes k.. in; the last step done
    load(k + g.ahead * P);
    if (T == 1) {                               // out_prev = cur's centre
      for (int p = max(k, cz); p < min(k + P, ez); ++p)
        for (int y = cy + warp; y < ey; y += n_warps)
          for (int x = cx + lane; x < ex; x += 32) {
            const long long o = p * g.sz + (long long)y * g.nx + x;
            out_prev[o] = cur[o];
          }
    }
    for (int s = 1; s <= T; ++s) {
      const LevelRow& L = lr[s];
      const int p0 = k - s * R;                 // level s's first plane
      if (p0 + P <= L.zlo || p0 >= L.zhi) continue;   // uniform over the CTA
      const int y0 = L.y0, y1 = L.y1, x0 = L.x0, x1 = L.x1, h = L.h;
#pragma unroll
      for (int pp = 0; pp < P; ++pp) {          // level s's planes
        const int p = p0 + pp;
        if (p < L.zlo || p >= L.zhi) continue;
        const long long plane = p * g.sz;
        // every stream of this plane as (base, row width): cell (y, x) is
        // at base[y * width + x]. Level s-1 (taps), level s-2 (2nd order),
        // cur (the frame), the coefficients and level s itself.
        S* dst = s < T ? ring(s, p) : out_cur + plane;
        const int dw = s < T ? rr[s].width : g.nx;
        const bool pv_ring = s > 2 || (s == 2 && !kInPlace);
        const S* pv = pv_ring ? ring(s - 2, p)
                              : (s == 1 ? prev : cur) + plane;
        const int pw = pv_ring ? rr[s - 2].width : g.nx;
        const S* cf = coeff + plane;
        const bool inner = p >= R && p < g.nz - R && y0 >= R
            && y1 <= g.ny - R && x0 >= R && x1 <= g.nx - R;

        // the cells, with level s-1 read at `src` (row width sw) and its
        // taps at `taps`: run once with both derived from the shared-memory
        // array, so that the taps compile to shared-memory loads, or with
        // cur's plane and the grid's tap offsets (level 1, cur in place).
        // A thread updates FUSED_CELLS cells (y, x + v*h) of the box, h its
        // width over their number, walking (y, x) over the box's first h
        // columns in steps of the block size.
        auto cells = [&](const S* src, int sw, const auto* taps) {
          const int ry = L.ry, rx = nthr - ry * h;
          const int q = quot(threadIdx.x, L.inv);
          int y = y0 + q, x = x0 + (int)threadIdx.x - q * h;
          for (; y < y1; y += ry, x += rx) {
            if (x >= x0 + h) {
              x -= h;
              if (++y >= y1) break;
            }
            int n = 1;
#pragma unroll
            for (int v = 1; v < FUSED_CELLS(kHoist); ++v)
              n += x + v * h < x1;
            S* out = dst + y * dw + x;
            const S* in = src + y * sw + x;
            const S* pc = pv + y * pw + x;
            const long long coff = (long long)y * g.nx + x;
            if (inner) {
              update_cell<S, S, FUSED_CELLS(kHoist), kHoist>(
                  in, taps, pc, out, cf, coff, g.grid_elems, op, h, n);
            } else {          // cells of the frame among them: one at a time
              const bool fr_ring = !kInPlace && s <= 2;
              const S* fr = fr_ring ? ring(0, p) : cur + plane;
              const int fw = fr_ring ? rr[0].width : g.nx;
              for (int v = 0; v < n; ++v) {
                const int xv = x + v * h, o = v * h;
                if (p < R || p >= g.nz - R || y < R || y >= g.ny - R
                    || xv < R || xv >= g.nx - R)
                  out[o] = fr[y * fw + xv];
                else
                  update_cell<S, S>(in + o, taps, pc + o, out + o, cf,
                                    coff + o, g.grid_elems, op);
              }
            }
          }
        };
        if (!kInPlace || s > 1) {
          const RingRow& qa = rr[s - 1];
          const int jj = p - qa.depth * quot(p, qa.inv);
          cells(sm + qa.base + jj * qa.plane, qa.width,
                tab + qa.tab + jj * g.n_taps);
        } else {
          cells(cur + plane, g.nx, op.tap_off);
        }
      }
      if (s == T) continue;
      __syncthreads();                // level s+1 reads what level s wrote
      if (s == T - 1) {                         // level T-1's centre
        const int w = rr[s].width;
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          const int p = p0 + pp;
          if (p < max(cz, L.zlo) || p >= min(ez, L.zhi)) continue;
          const S* c = ring(s, p);
          for (int y = cy + warp; y < ey; y += n_warps)
            for (int x = cx + lane; x < ex; x += 32)
              out_prev[p * g.sz + y * g.nx + x] = c[y * w + x];
        }
      }
    }
  }
}

template <typename S, int kHoist>
static void* pick(int in_place) {
  return in_place ? (void*)fused_kernel<S, true, kHoist, 1>
                  : (void*)fused_kernel<S, false, kHoist, 1>;
}

// The kernel instance for a stream type, layout, planes a step (two only
// in place without hoisted loads: read_geo) and hoisted groups: 0, 8 or
// 16, the fewest that cover the op's array-coefficient groups, so an op
// without them keeps its registers.
template <typename S>
static void* pick(int in_place, int planes, int hoist) {
  if (planes == 2) return (void*)fused_kernel<S, true, 0, 2>;
  if (hoist == 0) return pick<S, 0>(in_place);
  if (hoist == 8) return pick<S, 8>(in_place);
  return pick<S, 16>(in_place);
}

static void* kernel_of(int stream_type, const FusedGeo& g, int in_place) {
  switch (stream_type) {
    case T_F32: return pick<float>(in_place, g.planes, g.hoist);
    case T_F64: return pick<double>(in_place, g.planes, g.hoist);
    case T_BF16: return pick<__nv_bfloat16>(in_place, g.planes, g.hoist);
    case T_F16: return pick<__half>(in_place, g.planes, g.hoist);
  }
  return nullptr;
}

// geo: nz, ny, nx, bz, by, bx, ty, radius, t_block, threads, planes,
//      in_place, n_arrays, smem_bytes, tab_ints, ahead, hoisted groups (0, 8
//      or 16: the kernel instance), then 7 ring fields
//      (mx, my, width, height, depth, base, tab) per level s < t_block
//      (zeros for a level without a ring).
#define FUSED_GEO_HEAD 17
static int read_geo(const long long* geo, FusedGeo& g, int& in_place) {
  g = FusedGeo{};
  g.nz = (int)geo[0]; g.ny = (int)geo[1]; g.nx = (int)geo[2];
  g.bz = (int)geo[3]; g.by = (int)geo[4]; g.bx = (int)geo[5];
  g.ty = (int)geo[6];
  g.radius = (int)geo[7]; g.t_block = (int)geo[8]; g.threads = (int)geo[9];
  g.planes = (int)geo[10];
  in_place = (int)geo[11];
  g.n_arrays = (int)geo[12];
  g.smem_bytes = (int)geo[13];
  const long long tab_ints = geo[14];
  g.ahead = (int)geo[15];
  g.hoist = (int)geo[16];
  if (g.nz < 1 || g.ny < 1 || g.nx < 1 || g.bz < 1 || g.by < 1 || g.bx < 1
      || g.ty < 1 || g.ty > g.by || g.radius < 1 || g.t_block < 1
      || g.t_block > FUSED_MAX_LEVELS || g.planes < 1
      || g.planes > FUSED_MAX_PLANES
      || (g.planes > 1 && (!in_place || g.hoist != 0))
      || g.threads < 32 || g.threads % 32 || g.threads > FUSED_MAX_THREADS
      || g.smem_bytes < 4 * tab_ints || g.ahead < 1 || g.ahead > 2
      || (g.hoist != 0 && g.hoist != 8 && g.hoist != 16)
      || g.nz >= (1 << 16) || (long long)g.ny * g.nx >= (1LL << 31))
    return E_GEOMETRY;
  const long long* f = geo + FUSED_GEO_HEAD;
  for (int s = 0; s < g.t_block; ++s, f += 7) {
    Ring& q = g.ring[s];
    q.mx = (int)f[0]; q.my = (int)f[1]; q.width = (int)f[2];
    q.height = (int)f[3]; q.depth = (int)f[4]; q.base = (int)f[5];
    q.tab = (int)f[6];
    if ((s > 0 || !in_place)
        && (q.width < 1 || q.height < 1 || q.depth < 1 || q.base % 16
            || q.base < 4 * tab_ints || q.base >= g.smem_bytes))
      return E_GEOMETRY;
  }
  g.sz = (long long)g.ny * g.nx;
  g.grid_elems = g.sz * g.nz;
  return 0;
}

static dim3 grid_of(const FusedGeo& g) {
  return dim3((g.nx + g.bx - 1) / g.bx,
              (g.ny + g.by - 1) / g.by * ((g.by + g.ty - 1) / g.ty),
              (g.nz + g.bz - 1) / g.bz);
}

extern "C" {

// One launch of t_block steps on `stream`: (out_cur, out_prev) = the state
// after t_block and t_block - 1 steps, every cell.
//   geo          see read_geo (stencil_fused._geometry)
//   taps[n]      linear tap offsets in grid layout, group order
//   taps3[3n]    (dz, dy, dx) of the same taps
//   groups, values, n_groups, time_order: the operator (make_op)
// Returns 0, a negative launcher error, or the cudaError_t of the launch.
int fused_pass(int stream_type, void* out_cur, void* out_prev,
               const void* cur, const void* prev, const void* coeff,
               const long long* geo, const long long* taps, const int* taps3,
               int n_taps, const int* groups, const double* values,
               int n_groups, int time_order, int device, void* stream) {
  Op op;
  const int bad_op = make_op(op, taps, n_taps, groups, values, n_groups,
                             time_order);
  if (bad_op) return bad_op;
  FusedGeo g;
  int in_place = 0;
  if (read_geo(geo, g, in_place)) return E_GEOMETRY;
  g.n_taps = n_taps;
  TapDelta td;
  if (make_tap_delta(td, taps3, n_taps, g.radius)) return E_OP;
  if (g.n_arrays > 0 && coeff == nullptr) return E_GEOMETRY;
  void* fn = kernel_of(stream_type, g, in_place);
  if (fn == nullptr) return E_TYPES;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&out_cur, &out_prev, &cur, &prev, &coeff, &g, &op, &td};
  err = cudaLaunchKernel(fn, grid_of(g), dim3(g.threads), args,
                         g.smem_bytes, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

// The resident CTAs per SM of the kernel fused_pass would launch for
// `geo`, by the occupancy API: out[0].
int fused_config(int stream_type, const long long* geo, int device,
                 int* out) {
  FusedGeo g;
  int in_place = 0;
  if (read_geo(geo, g, in_place)) return E_GEOMETRY;
  void* fn = kernel_of(stream_type, g, in_place);
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

const char* fused_error_string(int code) {
  return stencil_error_string(code);
}

}  // extern "C"
