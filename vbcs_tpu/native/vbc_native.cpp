// Native fast paths for vbcs_tpu (C++17, no external deps).
//
// Performance-critical host-side routines, mirroring the roles the
// reference implements with specialized Julia (SURVEY.md §2.3, §2.9):
//
//  * dp_partition — the DynamicTotalChunker split-point DP
//    (ChainPartitioners' optimal partitioner; O(nnz + n*W*R) with the
//    last-occurrence sliding-window counters described in
//    vbcs_tpu/plan/dynamic.py).  Covers every 1-D cost model via
//    per-width alpha/beta/gamma tables and separable rank-R 2-D models
//    via weighted group counters.
//
//  * pack_1dvbc — the two-pass CSC -> 1D-VBC converter (reference
//    src/constructors_1DVBC.jl:9-92): pass 1 counts distinct rows per
//    stripe with a last-seen histogram, pass 2 merges column lists into
//    zero-filled w-wide blocks.
//
// Exposed with C linkage for ctypes.  All indices are int64, 0-based.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>
#include <algorithm>

extern "C" {

// Optimal split-point DP.
//
//   n            number of columns
//   num_groups   distinct-count granularity (rows for 1-D, row-blocks
//                for 2-D models)
//   pos[n+1]     CSC column pointers
//   grp[nnz]     group id per nonzero (row id, or row-block id)
//   W            max stripe width
//   R            number of weighted counters (1 for 1-D models)
//   alpha_tab[W]     per-width fixed stripe cost
//   beta_tabs[R*W]   per-width per-distinct-group cost, R major
//   gamma_tab[W]     per-width per-nonzero cost (may be null)
//   weights[R*num_groups] counter weights (may be null => unit, R=1)
//   delta_tab[W]     per-width per-EXCESS-8-block-group cost (may be
//                    null; charges max(ceil(distinct/8) - 1, 0);
//                    only meaningful with unit weights, R = 1)
//   out_spl[n+1] resulting split points (0-based), out_len the count+1
//
// Tie-break: narrowest stripe wins (first minimum over widths 1..W).
void dp_partition(int64_t n, int64_t num_groups, const int64_t* pos,
                  const int64_t* grp, int64_t W, int64_t R,
                  const double* alpha_tab, const double* beta_tabs,
                  const double* gamma_tab, const double* weights,
                  const double* delta_tab,
                  int64_t* out_spl, int64_t* out_len) {
  std::vector<int64_t> lst(static_cast<size_t>(num_groups > 0 ? num_groups : 1),
                           -1);
  // cnt[r][c]: weight of groups whose last occurrence is column c
  std::vector<double> cnt(static_cast<size_t>(R * n), 0.0);
  std::vector<double> opt(static_cast<size_t>(n + 1),
                          std::numeric_limits<double>::infinity());
  std::vector<int64_t> prev(static_cast<size_t>(n + 1), 0);
  std::vector<double> win(static_cast<size_t>(R * W), 0.0);
  opt[0] = 0.0;

  for (int64_t jp = 1; jp <= n; ++jp) {
    const int64_t c = jp - 1;
    for (int64_t q = pos[c]; q < pos[c + 1]; ++q) {
      const int64_t g = grp[q];
      const int64_t old = lst[g];
      for (int64_t r = 0; r < R; ++r) {
        const double wgt = weights ? weights[r * num_groups + g] : 1.0;
        if (old >= 0) cnt[r * n + old] -= wgt;
        cnt[r * n + c] += wgt;
      }
      lst[g] = c;
    }
    const int64_t W_eff = W < jp ? W : jp;
    // suffix sums over the window, widths 1..W_eff
    double best = std::numeric_limits<double>::infinity();
    int64_t best_j = jp - 1;
    for (int64_t r = 0; r < R; ++r) win[r * W] = 0.0;  // scratch slot
    double acc[8 > 1 ? 8 : 1];  // small-R fast path storage
    std::vector<double> accv;
    double* a;
    if (R <= 8) {
      a = acc;
    } else {
      accv.assign(static_cast<size_t>(R), 0.0);
      a = accv.data();
    }
    for (int64_t r = 0; r < R; ++r) a[r] = 0.0;
    for (int64_t wdt = 1; wdt <= W_eff; ++wdt) {
      const int64_t j = jp - wdt;
      for (int64_t r = 0; r < R; ++r) a[r] += cnt[r * n + j];
      // stripe cost accumulated FIRST, opt[j] added LAST — the exact
      // float-addition order of the NumPy oracle's
      // ``opt[j] + cost_fn(...)`` (integer-valued tables masked the
      // difference; the fitted time model's fractional tables exposed
      // tie flips between the two orders)
      double stripe = alpha_tab[wdt - 1];
      for (int64_t r = 0; r < R; ++r)
        stripe += a[r] * beta_tabs[r * W + wdt - 1];
      if (gamma_tab)
        stripe += gamma_tab[wdt - 1] * static_cast<double>(pos[jp] - pos[j]);
      if (delta_tab) {
        const int64_t nb = static_cast<int64_t>(a[0] + 0.5);
        const int64_t excess = (nb + 7) / 8 - 1;
        if (excess > 0)
          stripe += delta_tab[wdt - 1] * static_cast<double>(excess);
      }
      const double cost = opt[j] + stripe;
      if (cost < best) {
        best = cost;
        best_j = j;
      }
    }
    opt[jp] = best;
    prev[jp] = best_j;
  }

  // backtrack
  std::vector<int64_t> rev;
  int64_t j = n;
  rev.push_back(j);
  while (j > 0) {
    j = prev[j];
    rev.push_back(j);
  }
  const int64_t len = static_cast<int64_t>(rev.size());
  for (int64_t i = 0; i < len; ++i) out_spl[i] = rev[len - 1 - i];
  *out_len = len;
}

// Pass 1 of CSC -> 1D-VBC: count distinct rows per stripe.
//   spl[L+1] column partition; out pos[L+1], ofs[L+1] (0-based, pos[0]=0)
void pack_1dvbc_count(int64_t m, int64_t n, const int64_t* pos,
                      const int64_t* idx, int64_t L, const int64_t* spl,
                      int64_t* out_pos, int64_t* out_ofs) {
  std::vector<int64_t> hst(static_cast<size_t>(m > 0 ? m : 1), -1);
  out_pos[0] = 0;
  out_ofs[0] = 0;
  for (int64_t l = 0; l < L; ++l) {
    const int64_t j0 = spl[l], j1 = spl[l + 1];
    int64_t blocks = 0;
    for (int64_t q = pos[j0]; q < pos[j1]; ++q) {
      const int64_t i = idx[q];
      if (hst[i] < l) {
        ++blocks;
        hst[i] = l;
      }
    }
    out_pos[l + 1] = out_pos[l] + blocks;
    out_ofs[l + 1] = out_ofs[l] + blocks * (j1 - j0);
  }
}

// Pass 2: w-way merge of each stripe's column lists into blocks
// (float64 values).  out_idx sized pos[L], out_val sized ofs[L], both
// preallocated; out_val must be zero-initialized by the caller.
void pack_1dvbc_fill(int64_t m, int64_t n, const int64_t* pos,
                     const int64_t* idx, const double* val, int64_t L,
                     const int64_t* spl, const int64_t* bpos,
                     const int64_t* bofs, int64_t* out_idx,
                     double* out_val) {
  std::vector<int64_t> cur(64);
  for (int64_t l = 0; l < L; ++l) {
    const int64_t j0 = spl[l], j1 = spl[l + 1];
    const int64_t w = j1 - j0;
    if (w == 1) {
      int64_t Q = bpos[l], q = bofs[l];
      for (int64_t p = pos[j0]; p < pos[j0 + 1]; ++p) {
        out_idx[Q++] = idx[p];
        out_val[q++] = val[p];
      }
      continue;
    }
    if (static_cast<int64_t>(cur.size()) < w) cur.resize(w);
    for (int64_t d = 0; d < w; ++d) cur[d] = pos[j0 + d];
    int64_t Q = bpos[l], q = bofs[l];
    for (;;) {
      int64_t i = std::numeric_limits<int64_t>::max();
      for (int64_t d = 0; d < w; ++d)
        if (cur[d] < pos[j0 + d + 1] && idx[cur[d]] < i) i = idx[cur[d]];
      if (i == std::numeric_limits<int64_t>::max()) break;
      for (int64_t d = 0; d < w; ++d) {
        if (cur[d] < pos[j0 + d + 1] && idx[cur[d]] == i) {
          out_val[q] = val[cur[d]];
          ++cur[d];
        }  // else leave the zero fill
        ++q;
      }
      out_idx[Q++] = i;
    }
  }
}

}  // extern "C"

extern "C" {

// Greedy overlap chunker (reference OverlapChunker(rho, w_max)): a
// column joins the current stripe when |rows(c) & rows(c0)| >=
// rho * max(|rows(c)|, |rows(c0)|) against the stripe's leading column.
// Writes split points; returns count via out_len.
void overlap_chunk(int64_t n, const int64_t* pos, const int64_t* idx,
                   double rho, int64_t w_max, int64_t* out_spl,
                   int64_t* out_len) {
  int64_t count = 0;
  out_spl[count++] = 0;
  if (n == 0) {
    *out_len = count;
    return;
  }
  int64_t c0 = 0;
  for (int64_t c = 1; c < n; ++c) {
    const int64_t width = c - c0;
    bool ok = false;
    if (width < w_max) {
      const int64_t a0 = pos[c0], a1 = pos[c0 + 1];
      const int64_t b0 = pos[c], b1 = pos[c + 1];
      const int64_t la = a1 - a0, lb = b1 - b0;
      const int64_t denom = la > lb ? la : lb;
      if (denom == 0) {
        ok = true;  // two empty columns always merge
      } else {
        int64_t i = a0, j = b0, inter = 0;
        while (i < a1 && j < b1) {
          if (idx[i] < idx[j]) ++i;
          else if (idx[i] > idx[j]) ++j;
          else { ++inter; ++i; ++j; }
        }
        ok = static_cast<double>(inter) >= rho * static_cast<double>(denom);
      }
    }
    if (!ok) {
      out_spl[count++] = c;
      c0 = c;
    }
  }
  out_spl[count++] = n;
  *out_len = count;
}

}  // extern "C"
