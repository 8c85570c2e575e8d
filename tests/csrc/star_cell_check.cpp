// Host build of csrc/stencil_cell.cuh (tests/test_torch_star.py builds it
// with stand-ins for the CUDA headers): the star layouts against the ops
// the test reads on stdin, and update_cell's star form against its generic
// form, bit for bit, on a ring of planes whose z taps wrap.
//
// stdin: the number of ops, then per op its tap count, group count, each
// group's size and kind (1: a stream) and the (dz, dy, dx) of every tap in
// group order. stdout: per op
// "layout <L>" (0: none matches); then per layout and type
// "update <L> <type> <cells> <differing>".
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "stencil_cell.cuh"

static int matching_layout(const Op& op, const TapDelta& td, int n_taps) {
  int found = 0;
  for (int L = 1; L <= STAR_LAYOUTS; ++L)
    if (star_matches(L, op, td, n_taps)) found = found ? -1 : L;
  return found;
}

// One op of layout L (its groups' kind), the given time order and scale;
// every row of a ring of D planes, the cells 1 or 2 (V = 2, 32 apart) at
// several (y, x).
template <typename S, int L>
static int check_update(int time_order, int scale_kind, unsigned seed,
                        int* cells) {
  using Lay = Star<L>;
  const int R = Lay::R, D = 5 + 3 * R, wy = 6 + 2 * R, wx = 40 + 2 * R;
  const int plane = wy * wx;
  std::mt19937 rng(seed);
  std::normal_distribution<double> nd;
  std::vector<S> win(D * plane), prev(D * plane), coeff(16 * D * plane);
  for (auto& x : win) x = (S)nd(rng);
  for (auto& x : prev) x = (S)nd(rng);
  for (auto& x : coeff) x = (S)(0.1 * nd(rng));
  Op op{};
  op.n_groups = Lay::kGroups;
  op.time_order = time_order;
  op.scale_kind = time_order == 2 ? scale_kind : -1;
  op.scale_slot = 0;
  int slot = scale_kind == 1 ? 1 : 0;
  for (int g = 0; g <= Lay::kGroups; ++g) op.grp_start[g] = Lay::start(g);
  for (int g = 0; g < Lay::kGroups; ++g) {
    op.grp_kind[g] = Lay::kArrays ? 1 : 0;
    op.grp_slot[g] = op.grp_kind[g] ? slot++ : 0;
    op.grp_d[g] = nd(rng);
    op.grp_f[g] = (float)op.grp_d[g];
  }
  op.scale_d = nd(rng);
  op.scale_f = (float)op.scale_d;
  std::vector<int> tab(D * Lay::kTaps);     // mwd.cu's per-slot table
  for (int s = 0; s < D; ++s)
    for (int t = 0; t < Lay::kTaps; ++t) {
      int d[3] = {0, 0, 0};
      if (Lay::axis(t) >= 0) d[Lay::axis(t)] = Lay::dist(t);
      const int s2 = ((s + d[0]) % D + D) % D;
      tab[s * Lay::kTaps + t] = (s2 - s) * plane + d[1] * wx + d[2];
    }
  int bad = 0;
  for (int s = 0; s < D; ++s) {
    const StarTaps<L> st(s, D, plane, wx);
    for (int t = 0; t < Lay::kTaps; ++t)
      bad += st.at(t) != tab[s * Lay::kTaps + t];
    for (int y = R; y < wy - R; y += 2)
      for (int x = R; x < wx - R - 32; x += 3)
        for (int n = 1; n <= 2; ++n) {
          const int c = s * plane + y * wx + x;
          std::vector<S> a(prev), b(prev);
          update_cell<S, S, 2>(win.data() + c, st, a.data() + c,
                               a.data() + c, coeff.data(), c,
                               (long long)D * plane, op, 32, n);
          update_cell<S, S, 2>(win.data() + c, tab.data() + s * Lay::kTaps,
                               b.data() + c, b.data() + c, coeff.data(), c,
                               (long long)D * plane, op, 32, n);
          for (int v = 0; v < 2; ++v) {
            *cells += v < n;
            bad += memcmp(&a[c + 32 * v], &b[c + 32 * v], sizeof(S)) != 0;
            bad += v >= n && memcmp(&a[c + 32 * v], &prev[c + 32 * v],
                                    sizeof(S)) != 0;
          }
        }
  }
  return bad;
}

template <typename S, int L>
static void report(const char* type) {
  int cells = 0, bad = 0;
  unsigned seed = 17 * L;
  for (int rep = 0; rep < 2; ++rep) {
    bad += check_update<S, L>(1, -1, ++seed, &cells);
    for (int scale = -1; scale <= 1; ++scale)
      bad += check_update<S, L>(2, scale, ++seed, &cells);
  }
  printf("update %d %s %d %d\n", L, type, cells, bad);
}

template <int L>
static void report_both() {
  report<float, L>("f32");
  report<double, L>("f64");
}

int main() {
  int n_ops = 0;
  if (scanf("%d", &n_ops) != 1) return 2;
  for (int i = 0; i < n_ops; ++i) {
    int n_taps = 0, n_groups = 0;
    if (scanf("%d %d", &n_taps, &n_groups) != 2) return 2;
    Op op{};
    op.n_groups = n_groups;
    for (int g = 0; g < n_groups; ++g) {
      int size = 0;
      if (scanf("%d %d", &size, &op.grp_kind[g]) != 2) return 2;
      op.grp_start[g + 1] = op.grp_start[g] + size;
    }
    TapDelta td{};
    for (int t = 0; t < n_taps; ++t) {
      int dz, dy, dx;
      if (scanf("%d %d %d", &dz, &dy, &dx) != 3) return 2;
      td.dz[t] = (signed char)dz;
      td.dy[t] = (signed char)dy;
      td.dx[t] = (signed char)dx;
    }
    printf("layout %d\n", matching_layout(op, td, n_taps));
  }
  report_both<1>();
  report_both<2>();
  report_both<3>();
  report_both<4>();
  report_both<5>();
  report_both<6>();
  report_both<7>();
  return 0;
}
