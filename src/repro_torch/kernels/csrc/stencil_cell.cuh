// The lattice update shared by the port's three stencil kernels
// (mwd.cu: K1, sweep.cu: K2, fused.cu: K3).
//
// It holds the C-ABI type and error codes, the operator table `Op` that the
// Python wrappers fill from a StencilOp (and its taps' displacements,
// `TapDelta`), the numeric traits `Num<>`, K1's compile-time star layouts
// (`Star`) and `update_cell`. This is the
// one arithmetic that all three kernels and the plain PyTorch sweep
// (repro_torch.core.ir.sweep_region) agree on bit for bit: the taps are
// summed left-associatively per coefficient group in `op.groups` order, one
// multiply per group, groups accumulated in order, and a 2nd-order op wraps
// it as 2*V - prev [+ scale*acc]. Every operation rounds to the accumulator
// type, and the kernels are built with -fmad=false so that no multiply-add
// is contracted.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define STENCIL_MAX_TAPS 128
#define STENCIL_MAX_GROUPS 64

// stream / accumulator type codes shared with the Python wrappers
enum { T_F32 = 0, T_F64 = 1, T_BF16 = 2, T_F16 = 3 };
// launcher errors (negative; positive values are cudaError_t codes)
enum { E_TYPES = -1, E_OP = -2, E_GEOMETRY = -3 };

struct Op {
  int n_groups;
  int time_order;
  int scale_kind;         // -1 none, 0 const, 1 array
  int scale_slot;
  float scale_f;
  double scale_d;
  int grp_start[STENCIL_MAX_GROUPS + 1];
  int grp_kind[STENCIL_MAX_GROUPS];    // 0 const, 1 array
  int grp_slot[STENCIL_MAX_GROUPS];
  float grp_f[STENCIL_MAX_GROUPS];     // const value in the float opmath type
  double grp_d[STENCIL_MAX_GROUPS];    // ... and in double
  long long tap_off[STENCIL_MAX_TAPS]; // linear offsets in the grid, group order
};

// The (dz, dy, dx) of every tap, group order: the kernels that keep their
// levels in shared-memory z-rings (K1, K3) build per-slot offset tables
// from it.
struct TapDelta {
  signed char dz[STENCIL_MAX_TAPS], dy[STENCIL_MAX_TAPS], dx[STENCIL_MAX_TAPS];
};

// Fill `op` from the wrappers' tables:
//   taps[n_taps]     linear tap offsets in group order
//   groups[3*G+2]    (count, kind, slot) per group, then (scale_kind, slot)
//   values[G+1]      const value per group (0 for array groups), then the
//                    scale's
// Returns 0 or E_OP.
static inline int make_op(Op& op, const long long* taps, int n_taps,
                          const int* groups, const double* values,
                          int n_groups, int time_order) {
  if (n_taps < 1 || n_taps > STENCIL_MAX_TAPS || n_groups < 1
      || n_groups > STENCIL_MAX_GROUPS)
    return E_OP;
  op.n_groups = n_groups;
  op.time_order = time_order;
  op.grp_start[0] = 0;
  for (int i = 0; i < n_groups; ++i) {
    op.grp_start[i + 1] = op.grp_start[i] + groups[3 * i];
    op.grp_kind[i] = groups[3 * i + 1];
    op.grp_slot[i] = groups[3 * i + 2];
    op.grp_d[i] = values[i];
    op.grp_f[i] = (float)values[i];
  }
  if (op.grp_start[n_groups] != n_taps) return E_OP;
  op.scale_kind = groups[3 * n_groups];
  op.scale_slot = groups[3 * n_groups + 1];
  op.scale_d = values[n_groups];
  op.scale_f = (float)values[n_groups];
  for (int t = 0; t < n_taps; ++t) op.tap_off[t] = taps[t];
  return 0;
}

// Fill `td` from taps3[3*n_taps] = (dz, dy, dx) per tap; returns E_OP if a
// tap lies beyond `radius`.
static inline int make_tap_delta(TapDelta& td, const int* taps3, int n_taps,
                                 int radius) {
  if (n_taps < 1 || n_taps > STENCIL_MAX_TAPS) return E_OP;
  for (int t = 0; t < n_taps; ++t) {
    for (int a = 0; a < 3; ++a)
      if (taps3[3 * t + a] < -radius || taps3[3 * t + a] > radius)
        return E_OP;
    td.dz[t] = (signed char)taps3[3 * t];
    td.dy[t] = (signed char)taps3[3 * t + 1];
    td.dx[t] = (signed char)taps3[3 * t + 2];
  }
  return 0;
}

static inline const char* stencil_error_string(int code) {
  switch (code) {
    case E_TYPES: return "unsupported stream/accumulator dtype pair";
    case E_OP: return "operator exceeds the kernel's tap or group limits";
    case E_GEOMETRY: return "invalid launch geometry";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// M is the type an operation computes in (PyTorch's opmath type); round()
// rounds an M value to the storage type T.
template <typename T> struct Num;
template <> struct Num<float> {
  using M = float;
  __device__ static float load(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
};
template <> struct Num<double> {
  using M = double;
  __device__ static double load(double v) { return v; }
  __device__ static double round(double v) { return v; }
  __device__ static double store(double v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  using M = float;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Num<__half> {
  using M = float;
  __device__ static float load(__half v) { return __half2float(v); }
  __device__ static float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

template <typename M> __device__ M const_value(float f, double d);
template <> __device__ inline float const_value<float>(float f, double) {
  return f;
}
template <> __device__ inline double const_value<double>(float,
                                                       double d) {
  return d;
}

// K1's compile-time layouts: the structure of the paper's four star
// operators, of the adjoints of the two 7-point ones and of 7pt-const's
// masked twin, each with its taps in op.groups order, its group sizes and
// its groups' coefficient kind (every group const, or every group a
// stream). L = 1..7: 7pt-const (groups [1, 6], const), 7pt-var ([1] x 7,
// streams), 25pt-const ([1, 6, 6, 6, 6], const), 25pt-var ([1] + [2] x 12,
// streams), 7pt-const.T and 7pt-var.T (the 7-point layouts with every
// offset negated), 7pt-const+mask (7pt-const's taps, streams). Tap t is
// the centre (axis -1) or lies at `dist(t)` along `axis(t)` (0 z, 1 y, 2
// x); group g holds taps [start(g), start(g + 1)). The host matches an op
// against these (`_host.star_layout`) and the launcher checks the match
// (`star_matches`); the time order, the scale, the streams' slots and the
// constants stay the op's own.
#define STAR_LAYOUTS 7
// taps a star update loads ahead of the one it adds: the fastest of the
// depths measured for K1's f64 solves on an H100 (2, 3, 4, 6, all); with
// every tap's loads issued at once the 25-point instances spill registers
// (PERF.md)
#define STAR_AHEAD 3
template <int L> struct Star {
  static_assert(L >= 1 && L <= STAR_LAYOUTS, "no such star layout");
  static constexpr int kBase = L == 7 ? 1 : L > 4 ? L - 4 : L;
  static constexpr int kSign = L == 5 || L == 6 ? -1 : 1;
  static constexpr bool kArrays = L == 2 || L == 4 || L == 6 || L == 7;
  static constexpr int R = kBase <= 2 ? 1 : 4;
  static constexpr int kTaps = kBase <= 2 ? 7 : 25;
  static constexpr int kGroups =
      kBase == 1 ? 2 : kBase == 2 ? 7 : kBase == 3 ? 5 : 13;
  __host__ __device__ static constexpr int start(int g) {
    return g == 0 ? 0
        : kBase == 1 ? (g == 1 ? 1 : 7)
        : kBase == 2 ? g
        : kBase == 3 ? 1 + 6 * (g - 1)
                     : 1 + 2 * (g - 1);
  }
  __host__ __device__ static constexpr int group(int t) {
    return t == 0 ? 0
        : kBase == 1 ? 1
        : kBase == 2 ? t
        : kBase == 3 ? (t - 1) / 6 + 1
                     : (t - 1) / 2 + 1;
  }
  // 7-point: (z, -1), (z, +1), (y, -1), ...; 25pt-const: the six of
  // distance 1, then of 2, 3, 4; 25pt-var: (z, +1), (z, -1), (z, +2), ...
  __host__ __device__ static constexpr int axis(int t) {
    return t == 0 ? -1
        : kBase <= 2 ? (t - 1) / 2
        : kBase == 3 ? (t - 1) % 6 / 2
                     : (t - 1) / 8;
  }
  __host__ __device__ static constexpr int dist(int t) {
    return t == 0 ? 0
        : kBase <= 2 ? kSign * ((t - 1) % 2 ? 1 : -1)
        : kBase == 3 ? kSign * ((t - 1) % 2 ? 1 : -1) * ((t - 1) / 6 + 1)
                     : kSign * ((t - 1) % 2 ? -1 : 1) * ((t - 1) % 8 / 2 + 1);
  }
};

// The offsets of a star layout's taps from a cell of one ring row: the 2R
// ring-plane offsets of its z taps, wrapped with the ring (z[dz + R] for
// dz < 0, z[dz + R - 1] for dz > 0), and the window's row stride, so a y
// tap is dy * wx and an x tap its dx. update_cell takes the star path on it.
template <int L> struct StarTaps {
  using Layout = Star<L>;
  int z[2 * Star<L>::R];
  int wx;

  // the offsets of the row in ring slot `slot` of `depth` planes of `plane`
  __device__ __forceinline__ StarTaps(int slot, int depth, int plane,
                                      int wx_) : wx(wx_) {
    constexpr int R = Star<L>::R;
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
      const int dz = k < R ? k - R : k - R + 1;
      const int s2 = slot + dz;
      z[k] = (dz + (s2 < 0 ? depth : s2 >= depth ? -depth : 0)) * plane;
    }
  }
  __device__ __forceinline__ int at(int t) const {
    constexpr int R = Star<L>::R;
    const int a = Layout::axis(t), d = Layout::dist(t);
    return a < 0 ? 0 : a == 0 ? z[d < 0 ? d + R : d + R - 1]
                   : a == 1 ? d * wx : d;
  }
};

template <typename T> struct IsStar { static constexpr bool value = false; };
template <int L> struct IsStar<StarTaps<L>> {
  static constexpr bool value = true;
};

// Whether an op's taps (`td`, group order), group sizes and coefficient
// kinds are layout L's.
template <int L>
static inline bool star_matches(const Op& op, const TapDelta& td,
                                int n_taps) {
  using Lay = Star<L>;
  if (n_taps != Lay::kTaps || op.n_groups != Lay::kGroups) return false;
  for (int g = 0; g <= Lay::kGroups; ++g)
    if (op.grp_start[g] != Lay::start(g)) return false;
  for (int g = 0; g < Lay::kGroups; ++g)
    if (op.grp_kind[g] != (Lay::kArrays ? 1 : 0)) return false;
  for (int t = 0; t < n_taps; ++t) {
    const int d[3] = {td.dz[t], td.dy[t], td.dx[t]};
    for (int a = 0; a < 3; ++a)
      if (d[a] != (Lay::axis(t) == a ? Lay::dist(t) : 0)) return false;
  }
  return true;
}

static inline bool star_matches(int layout, const Op& op, const TapDelta& td,
                                int n_taps) {
  switch (layout) {
    case 1: return star_matches<1>(op, td, n_taps);
    case 2: return star_matches<2>(op, td, n_taps);
    case 3: return star_matches<3>(op, td, n_taps);
    case 4: return star_matches<4>(op, td, n_taps);
    case 5: return star_matches<5>(op, td, n_taps);
    case 6: return star_matches<6>(op, td, n_taps);
    case 7: return star_matches<7>(op, td, n_taps);
  }
  return false;
}

// The left-to-right sum of taps [t0, t1) at each of the n cells into s.
// With several cells (K1, K3) two taps' loads are issued before they are
// added, four with four cells or more (K2); with one taps go one at a
// time, since pairing them slowed K2 by 12-19 % at the 7-point ops on an
// H100 (PERF.md). The additions keep their order either way.
template <typename S, typename A, int V, typename Off>
__device__ __forceinline__ void tap_sum(const S* src, const Off* taps, int t0,
                                        int t1, int step, int n,
                                        typename Num<A>::M (&s)[V]) {
  using M = typename Num<A>::M;
  const Off o0 = taps[t0];
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (v < n) s[v] = M(Num<S>::load(src[o0 + v * step]));
  int t = t0 + 1;
  if constexpr (V >= 4) {
    for (; t + 3 < t1; t += 4) {    // four taps' loads in flight at once
      const Off oa = taps[t], ob = taps[t + 1], oc = taps[t + 2],
                od = taps[t + 3];
      S va[V], vb[V], vc[V], vd[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) {
          va[v] = src[oa + v * step];
          vb[v] = src[ob + v * step];
          vc[v] = src[oc + v * step];
          vd[v] = src[od + v * step];
        }
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) {
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(va[v])));
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(vb[v])));
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(vc[v])));
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(vd[v])));
        }
    }
  }
  if constexpr (V > 1) {
    for (; t + 1 < t1; t += 2) {    // two taps' loads in flight at once
      const Off oa = taps[t], ob = taps[t + 1];
      S va[V], vb[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) {
          va[v] = src[oa + v * step];
          vb[v] = src[ob + v * step];
        }
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) {
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(va[v])));
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(vb[v])));
        }
    }
    if (t < t1) {
      const Off o = taps[t];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n)
          s[v] = Num<A>::round(s[v] + M(Num<S>::load(src[o + v * step])));
    }
  } else {
    for (; t < t1; ++t)
      s[0] = Num<A>::round(s[0] + M(Num<S>::load(src[taps[t]])));
  }
}

// One lattice update at `n` <= V cells spaced `step` elements apart in
// every stream (K2 and K3: one cell, V = 1). `src`, `prev` and `out` point
// at the first cell: src is read at every tap, prev at the cell (the t-1
// level of a 2nd-order op), and the result goes to out, which may alias
// prev. The coefficient streams are read at `coeff[slot * cstride + coff]`.
//
// `taps` is either a table of tap offsets in src's own layout, in group
// order (the generic form, any op), or a `StarTaps` (K1's star instances):
// * generic: each tap offset and each entry of the op's tables is read once
//   for all V cells, the V sums are independent, and the coefficient loads
//   of the first H groups are all issued before the first sum, so their
//   latencies overlap (H = 0: each group loads its own);
// * star: the layout's taps, groups, coefficient kinds and offsets are
//   known at compile time, so no offset is read from memory and no group
//   branches on its kind; the loads of prev and of the coefficient and
//   scale streams are issued before the first addition, and each tap's
//   loads STAR_AHEAD taps before its addition; H plays no part.
// None of this changes an operation or its order, so every form, V and H
// gives the same bits.
template <typename S, typename A, int V = 1, int H = 0, typename Taps>
__device__ __forceinline__ void update_cell(const S* src, const Taps& taps,
                                            const S* prev, S* out,
                                            const S* coeff, long long coff,
                                            long long cstride, const Op& op,
                                            int step = 0, int n = 1) {
  using M = typename Num<A>::M;
  if constexpr (IsStar<Taps>::value) {
    using L = typename Taps::Layout;
    // a lane's missing cells (v >= n) read as 0, so no predicated load
    // keeps an older value alive; their results are never stored
    S tv[L::kTaps][V] = {}, pv[V] = {};
    M cv[L::kArrays ? L::kGroups : 1][V] = {}, sc[V] = {}, acc[V], s[V];
    constexpr int K = STAR_AHEAD < L::kTaps ? STAR_AHEAD : L::kTaps;
    auto load_tap = [&](int t) {
      const int o = taps.at(t);
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) tv[t][v] = src[o + v * step];
    };
#pragma unroll
    for (int t = 0; t < K; ++t) load_tap(t);
    if constexpr (L::kArrays) {
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        const S* cs = coeff + op.grp_slot[g] * cstride + coff;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v < n) cv[g][v] = M(Num<S>::load(cs[v * step]));
      }
    }
    if (op.time_order == 2) {
      const S* cs = coeff + op.scale_slot * cstride + coff;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) {
          pv[v] = prev[v * step];
          if (op.scale_kind == 1) sc[v] = M(Num<S>::load(cs[v * step]));
        }
    }
#pragma unroll
    for (int t = 0; t < L::kTaps; ++t) {
      if (t + K < L::kTaps) load_tap(t + K);
      const int g = L::group(t);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const M x = M(Num<S>::load(tv[t][v]));
        s[v] = t == L::start(g) ? x : Num<A>::round(s[v] + x);
      }
      if (t + 1 < L::start(g + 1)) continue;      // group g not summed yet
#pragma unroll
      for (int v = 0; v < V; ++v) {
        M c;
        if constexpr (L::kArrays)
          c = cv[g][v];
        else
          c = const_value<M>(op.grp_f[g], op.grp_d[g]);
        const M term = Num<A>::round(c * s[v]);
        acc[v] = g == 0 ? term : Num<A>::round(acc[v] + term);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (op.time_order == 2) {       // tap 0 is the centre: src[v * step]
        const M lead = Num<A>::round(
            Num<A>::round(M(2) * M(Num<S>::load(tv[0][v])))
            - M(Num<S>::load(pv[v])));
        if (op.scale_kind == 1) {
          acc[v] = Num<A>::round(lead + Num<A>::round(sc[v] * acc[v]));
        } else if (op.scale_kind == 0) {
          const M c = const_value<M>(op.scale_f, op.scale_d);
          acc[v] = Num<A>::round(lead + Num<A>::round(c * acc[v]));
        } else {
          acc[v] = Num<A>::round(lead + acc[v]);
        }
      }
      if (v < n) out[v * step] = Num<S>::store(acc[v]);
    }
  } else {
    M acc[V], s[V], cv[H > 0 ? H : 1][V], sc[V];
#pragma unroll
    for (int g = 0; g < H; ++g)
      if (g < op.n_groups && op.grp_kind[g]) {
        const S* cs = coeff + op.grp_slot[g] * cstride + coff;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v < n) cv[g][v] = M(Num<S>::load(cs[v * step]));
      }
    if (op.time_order == 2 && op.scale_kind == 1) {
      const S* cs = coeff + op.scale_slot * cstride + coff;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (v < n) sc[v] = M(Num<S>::load(cs[v * step]));
    }
#pragma unroll
    for (int g = 0; g < H; ++g) {
      if (g >= op.n_groups) break;
      tap_sum<S, A, V>(src, taps, op.grp_start[g], op.grp_start[g + 1], step,
                       n, s);
      const M k = const_value<M>(op.grp_f[g], op.grp_d[g]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v >= n) continue;
        const M term = Num<A>::round((op.grp_kind[g] ? cv[g][v] : k) * s[v]);
        acc[v] = g == 0 ? term : Num<A>::round(acc[v] + term);
      }
    }
    for (int g = H; g < op.n_groups; ++g) {
      tap_sum<S, A, V>(src, taps, op.grp_start[g], op.grp_start[g + 1], step,
                       n, s);
      const S* cs = coeff + op.grp_slot[g] * cstride + coff;
      const M k = const_value<M>(op.grp_f[g], op.grp_d[g]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v >= n) continue;
        const M c = op.grp_kind[g] ? M(Num<S>::load(cs[v * step])) : k;
        const M term = Num<A>::round(c * s[v]);
        acc[v] = g == 0 ? term : Num<A>::round(acc[v] + term);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v >= n) continue;
      if (op.time_order == 2) {
        const M lead = Num<A>::round(
            Num<A>::round(M(2) * M(Num<S>::load(src[v * step])))
            - M(Num<S>::load(prev[v * step])));
        if (op.scale_kind == 1) {
          acc[v] = Num<A>::round(lead + Num<A>::round(sc[v] * acc[v]));
        } else if (op.scale_kind == 0) {
          const M c = const_value<M>(op.scale_f, op.scale_d);
          acc[v] = Num<A>::round(lead + Num<A>::round(c * acc[v]));
        } else {
          acc[v] = Num<A>::round(lead + acc[v]);
        }
      }
      out[v * step] = Num<S>::store(acc[v]);
  
  }
}
}
