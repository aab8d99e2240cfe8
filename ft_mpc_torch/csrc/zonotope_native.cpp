// Native scenario-geometry engine: batched attainable-wrench zonotope facets.
//
// A copy of ft_mpc_tpu/runtime/zonotope_native.cpp, the JAX package's engine:
// the same source built with the same flags gives the same facets in the
// same row order.  Host-side counterpart of ft_mpc_torch/geometry/zonotope.py
// for large fault banks:
//
//   * distinct generator directions of the faulted thruster set,
//   * facet normals as nullspaces of 5-subsets (computed via the
//     generalized cross product / cofactor expansion instead of SVD),
//   * support-function offsets h(n) = n.c + sum_i max(0, n.g_i),
//   * canonical-sign dedup, normals sorted by their rounded coordinates,
//     each emitted as +n then -n,
//
// -- threaded over scenarios.  Exposed through a plain C ABI (ctypes,
// ft_mpc_torch/runtime/native.py builds it into build/ at first use).
// A degenerate (rank < 6) wrench set comes back with zero facets; the
// Python wrapper recomputes those rows with the numpy path.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread \
//            zonotope_native.cpp -o libzonotope_native.so

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kDim = 6;       // wrench dimension
constexpr int kSub = kDim - 1; // generators per facet-normal subset

using Vec6 = std::array<double, kDim>;

// Determinant of a 5x5 matrix (cofactor expansion, unrolled recursion).
double det5(const double m[5][5]) {
  double det = 0.0;
  double sub[4][4];
  for (int c = 0; c < 5; ++c) {
    for (int r = 1; r < 5; ++r) {
      int cc = 0;
      for (int c2 = 0; c2 < 5; ++c2) {
        if (c2 == c) continue;
        sub[r - 1][cc++] = m[r][c2];
      }
    }
    // det4 via cofactor over first row
    double d4 = 0.0;
    for (int c4 = 0; c4 < 4; ++c4) {
      double sub3[3][3];
      for (int r = 1; r < 4; ++r) {
        int cc = 0;
        for (int c2 = 0; c2 < 4; ++c2) {
          if (c2 == c4) continue;
          sub3[r - 1][cc++] = sub[r][c2];
        }
      }
      double d3 = sub3[0][0] * (sub3[1][1] * sub3[2][2] - sub3[1][2] * sub3[2][1]) -
                  sub3[0][1] * (sub3[1][0] * sub3[2][2] - sub3[1][2] * sub3[2][0]) +
                  sub3[0][2] * (sub3[1][0] * sub3[2][1] - sub3[1][1] * sub3[2][0]);
      d4 += ((c4 % 2 == 0) ? 1.0 : -1.0) * sub[0][c4] * d3;
    }
    det += ((c % 2 == 0) ? 1.0 : -1.0) * m[0][c] * d4;
  }
  return det;
}

// Generalized cross product: the vector orthogonal to 5 vectors in R^6.
// n_i = (-1)^i det(S with column i removed), S being (5 x 6).
Vec6 nullspace6(const double S[kSub][kDim]) {
  Vec6 n;
  double sub[5][5];
  for (int skip = 0; skip < kDim; ++skip) {
    for (int r = 0; r < kSub; ++r) {
      int cc = 0;
      for (int c = 0; c < kDim; ++c) {
        if (c == skip) continue;
        sub[r][cc++] = S[r][c];
      }
    }
    n[skip] = ((skip % 2 == 0) ? 1.0 : -1.0) * det5(sub);
  }
  return n;
}

double norm6(const Vec6& v) {
  double s = 0;
  for (double x : v) s += x * x;
  return std::sqrt(s);
}

struct Facet {
  Vec6 n;
  double b;
};

// Enumerate facets of Z = center + sum_i [0,1] * gens[:, i].
void zonotope_facets(const std::vector<Vec6>& gens, const Vec6& center,
                     std::vector<Facet>& out) {
  // Distinct unit directions (canonical sign).
  std::vector<Vec6> dirs;
  for (const auto& g : gens) {
    double n = norm6(g);
    if (n < 1e-12) continue;
    Vec6 u;
    for (int i = 0; i < kDim; ++i) u[i] = g[i] / n;
    int lead = 0;
    while (lead < kDim && std::fabs(u[lead]) <= 1e-9) ++lead;
    if (lead < kDim && u[lead] < 0)
      for (int i = 0; i < kDim; ++i) u[i] = -u[i];
    bool dup = false;
    for (const auto& d : dirs) {
      double diff = 0;
      for (int i = 0; i < kDim; ++i) diff += (d[i] - u[i]) * (d[i] - u[i]);
      if (diff < 1e-18) { dup = true; break; }
    }
    if (!dup) dirs.push_back(u);
  }

  const int k = static_cast<int>(dirs.size());
  std::vector<Vec6> normals;

  std::array<int, kSub> idx;
  for (int i = 0; i < kSub; ++i) idx[i] = i;
  if (k < kSub) return;

  auto emit = [&](const std::array<int, kSub>& sel) {
    double S[kSub][kDim];
    for (int r = 0; r < kSub; ++r)
      for (int c = 0; c < kDim; ++c) S[r][c] = dirs[sel[r]][c];
    Vec6 n = nullspace6(S);
    double nn = norm6(n);
    if (nn < 1e-10) return;  // rank-deficient subset
    for (int i = 0; i < kDim; ++i) n[i] /= nn;
    int lead = 0;
    while (lead < kDim && std::fabs(n[lead]) <= 1e-9) ++lead;
    if (lead < kDim && n[lead] < 0)
      for (int i = 0; i < kDim; ++i) n[i] = -n[i];
    normals.push_back(n);
  };

  // iterate all C(k, 5) combinations
  while (true) {
    emit(idx);
    int i = kSub - 1;
    while (i >= 0 && idx[i] == k - kSub + i) --i;
    if (i < 0) break;
    ++idx[i];
    for (int j = i + 1; j < kSub; ++j) idx[j] = idx[j - 1] + 1;
  }

  // dedup normals (round + sort)
  auto key = [](const Vec6& v) {
    std::array<int64_t, kDim> q;
    for (int i = 0; i < kDim; ++i)
      q[i] = static_cast<int64_t>(std::llround(v[i] * 1e10));
    return q;
  };
  std::sort(normals.begin(), normals.end(),
            [&](const Vec6& a, const Vec6& b) { return key(a) < key(b); });
  normals.erase(std::unique(normals.begin(), normals.end(),
                            [&](const Vec6& a, const Vec6& b) {
                              return key(a) == key(b);
                            }),
                normals.end());

  // Both orientations; offsets via support function.
  out.clear();
  out.reserve(2 * normals.size());
  for (const auto& n0 : normals) {
    for (int sgn = 0; sgn < 2; ++sgn) {
      Vec6 n;
      for (int i = 0; i < kDim; ++i) n[i] = (sgn ? -n0[i] : n0[i]);
      double b = 0;
      for (int i = 0; i < kDim; ++i) b += n[i] * center[i];
      for (const auto& g : gens) {
        double p = 0;
        for (int i = 0; i < kDim; ++i) p += n[i] * g[i];
        if (p > 0) b += p;
      }
      out.push_back({n, b});
    }
  }
}

}  // namespace

extern "C" {

// Batched attainable-wrench hulls.
//   D:          (6, n_thrusters) row-major
//   broken:     (batch, n_thrusters) 0/1
//   intensity:  (batch, n_thrusters)
// Outputs (pre-allocated by caller):
//   A:    (batch, max_facets, 6)
//   b:    (batch, max_facets)
//   mask: (batch, max_facets)
// Returns 0 on success, -1 if any scenario exceeds max_facets.
int ftmpc_batched_wrench_hulls(const double* D, int n_thrusters,
                               double max_thrust, const double* broken,
                               const double* intensity, int batch,
                               int max_facets, double* A, double* b,
                               double* mask, int n_threads) {
  std::vector<int> status(batch, 0);

  auto work = [&](int lo, int hi) {
    std::vector<Vec6> gens;
    std::vector<Facet> facets;
    for (int s = lo; s < hi; ++s) {
      const double* br = broken + s * n_thrusters;
      const double* in = intensity + s * n_thrusters;
      Vec6 center{};
      gens.clear();
      for (int t = 0; t < n_thrusters; ++t) {
        Vec6 col;
        for (int i = 0; i < kDim; ++i) col[i] = D[i * n_thrusters + t];
        if (br[t] > 0.5) {
          double f = in[t] * max_thrust;
          for (int i = 0; i < kDim; ++i) center[i] += f * col[i];
        } else {
          Vec6 g;
          for (int i = 0; i < kDim; ++i) g[i] = max_thrust * col[i];
          gens.push_back(g);
        }
      }
      zonotope_facets(gens, center, facets);
      if (static_cast<int>(facets.size()) > max_facets) {
        status[s] = -1;
        continue;
      }
      double* As = A + static_cast<int64_t>(s) * max_facets * kDim;
      double* bs = b + static_cast<int64_t>(s) * max_facets;
      double* ms = mask + static_cast<int64_t>(s) * max_facets;
      for (int f = 0; f < max_facets; ++f) {
        if (f < static_cast<int>(facets.size())) {
          for (int i = 0; i < kDim; ++i) As[f * kDim + i] = facets[f].n[i];
          bs[f] = facets[f].b;
          ms[f] = 1.0;
        } else {
          for (int i = 0; i < kDim; ++i) As[f * kDim + i] = 0.0;
          bs[f] = 1.0;
          ms[f] = 0.0;
        }
      }
    }
  };

  if (n_threads <= 1 || batch < 4) {
    work(0, batch);
  } else {
    n_threads = std::min<int>(n_threads, batch);
    std::vector<std::thread> pool;
    int chunk = (batch + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int lo = t * chunk, hi = std::min(batch, lo + chunk);
      if (lo < hi) pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
  }

  for (int s = 0; s < batch; ++s)
    if (status[s] != 0) return -1;
  return 0;
}

}  // extern "C"
