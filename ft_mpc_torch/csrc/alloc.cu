// Thruster allocation: hull test, FISTA zonotope projection, allocation
// ADMM with a Woodbury x-update, min-norm polish and fallback selection.
//
// Replaces ft_mpc_tpu/solvers/lanes_alloc.py:_alloc_kernel and
// _gauss_jordan6 (wrapper allocate_thrusters_lanes).  Per scenario:
//   1. feasible = all(hull_A w_total <= hull_b + 1e-7), w_total = w + ff;
//   2. 60 FISTA steps of min |c + G theta - w_total|^2, theta in [0,1]^16;
//   3. w_des = (feasible ? w_total : c + G theta) - ff;
//   4. 40 over-relaxed ADMM steps of min |u|^2 s.t. D u = w_des,
//      0 <= u <= u_ub, rho boosted on the equality rows and on pinned
//      thrusters; K = diag + D^T rho_eq D is applied through Woodbury with
//      a 6x6 capacitance matrix inverted by unpivoted Gauss-Jordan;
//   5. min-norm equality polish over healthy thrusters (second 6x6
//      Gauss-Jordan), then the FISTA feasible point replaces u only when
//      the equality error exceeds 1e-2 and the fallback's is smaller.
//
// Bound on the H100: neither bytes (~1.5 KB per scenario) nor FLOPs
// (~70 kFLOP per scenario, ~0.15 GFLOP at B=2048) -- it is a chain of
// ~100 dependent iterations per scenario (60 FISTA, 40 ADMM), so it is
// latency-bound: the time is the length of one scenario's chain.
//
// Design: a group of 16 lanes per scenario (two scenarios a warp, one warp
// a block), lane g owning thruster g.  A lane keeps column g of D and of G
// and its thruster's scalars (u_ub, rho_box, the Woodbury diagonal, theta,
// eta, x, z_box, y_box) in registers; the 6-vectors (w_total, w_des, y_eq)
// and the 6x6 inverses sit in every lane of the group.  Every 6-row sum
// over the 16 thrusters (G eta, D tv, D x~, D u, the capacitance matrices)
// is an xor butterfly over the group (offsets 8, 4, 2, 1) with its rows
// interleaved so that the shuffles of a level pipeline; both lanes of a
// pair add the same two values, so every lane ends with the same total bit
// for bit, and G^T r, D^T v and the 6x6 products are lane-local.  A FISTA
// step is one 4-level reduction, an ADMM step two, and B=2048 is 1,024
// warps in one wave.  What else lengthens the chain is kept off it:
//   - every input is loaded by unrolled, predicated loads issued together
//     (G, u_ub and the hull rows with neighbouring lanes on neighbouring
//     addresses; the hull rows staged through shared memory);
//   - the 12 divisions of a Gauss-Jordan pivot row are spread over the
//     group's lanes and gathered by shuffles;
//   - a zero numerator skips the IEEE division's slow path (div_pos).
// The hull facets are spread over the group's lanes, each facet's dot
// product in the order j = 0..5 as before, and the group votes, so the hull
// decision is the first design's bit for bit.  The arithmetic is the
// reference's except for the order of the 16-term sums.  No tensor cores:
// every product is a 6x16 matrix-vector product with one right-hand side,
// in fp32.
#include "common.cuh"

namespace {

constexpr int NW = 6;
constexpr int NT = 16;                    // thrusters: the lanes of a group
constexpr int THREADS = 32;
constexpr int GROUPS = THREADS / NT;      // scenarios per block
constexpr int FCHUNK = 32;                // hull facets staged per pass
constexpr int FPL = FCHUNK / NT;          // facets of a pass per lane: g + 16 m
constexpr int SPL = FCHUNK * NW / NT;     // floats of a pass each lane stages
constexpr int HSTRIDE = FCHUNK * NW + 1;  // odd: the two groups of a warp hit other banks
constexpr int NSYM = NW * (NW + 1) / 2;   // entries on and above the diagonal of a 6x6
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// a / b, correctly rounded as `/` is, but a zero a is returned as it is
// (0 / b is a zero of a's sign for every b > 0): the box duals and the
// identity half of the Gauss-Jordan rows are mostly zeros, and a zero
// numerator sends `/` down its slow path.
__device__ __forceinline__ float div_pos(float a, float b) {
  return (a == 0.f && b > 0.f) ? a : a / b;
}

// v[k] summed over the 16 lanes of the group, left in every lane of it.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N]) {
#pragma unroll
  for (int off = NT / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(FULL, v[k], off);
  }
}

// out = M v over the scenario's 16 thrusters, M[:, g] = col in lane g.
__device__ __forceinline__ void cols_sum(const float (&col)[NW], float v, float (&out)[NW]) {
#pragma unroll
  for (int a = 0; a < NW; ++a) out[a] = col[a] * v;
  group_sum(out);
}

// A column of D (or G) dotted with v, in the order a = 0..5.
__device__ __forceinline__ float col_dot(const float (&col)[NW], const float (&v)[NW]) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < NW; ++a) s += col[a] * v[a];
  return s;
}

// W = diag * I + sum_j D[:, j] D[:, j]^T s_j over the scenario's thrusters
// (s_j = s in lane j).  The 21 sums on and above the diagonal are reduced
// together and mirrored: (D_a D_e) s_j = (D_e D_a) s_j exactly.
__device__ __forceinline__ void capacitance(const float (&Dc)[NW], float s, float diag,
                                            float (&W)[NW * NW]) {
  float p[NSYM];
  int k = 0;
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int e = a; e < NW; ++e) p[k++] = Dc[a] * Dc[e] * s;
  group_sum(p);
  k = 0;
#pragma unroll
  for (int a = 0; a < NW; ++a)
#pragma unroll
    for (int e = a; e < NW; ++e, ++k) {
      W[a * NW + e] = ((a == e) ? diag : 0.f) + p[k];
      W[e * NW + a] = W[a * NW + e];
    }
}

// Inverse of an SPD 6x6 by Gauss-Jordan without pivoting (same elimination
// order as _gauss_jordan6: every row is updated from the pre-step matrix).
// Every lane of the group holds the whole matrix; lane g < 12 divides entry
// g of the pivot row and the row is gathered by shuffles, so a pivot waits
// for one division, not for twelve in a row.
__device__ __forceinline__ void gauss_jordan6(const float (&W)[NW * NW],
                                              float (&Winv)[NW * NW], int g, int base) {
  float aug[NW][2 * NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      aug[i][j] = W[i * NW + j];
      aug[i][NW + j] = (i == j) ? 1.f : 0.f;
    }
  }
#pragma unroll
  for (int p = 0; p < NW; ++p) {
    const float dp = aug[p][p];
    float num = aug[p][0];
#pragma unroll
    for (int j = 1; j < 2 * NW; ++j) num = (g == j) ? aug[p][j] : num;
    const float q = div_pos(num, dp);
    float piv[2 * NW];
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) piv[j] = __shfl_sync(FULL, q, base + j);
    float col[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) col[i] = aug[i][p];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int j = 0; j < 2 * NW; ++j)
        aug[i][j] = (i == p) ? piv[j] : aug[i][j] - col[i] * piv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) Winv[i * NW + j] = aug[i][NW + j];
}

__device__ __forceinline__ void mat6_vec(const float (&M)[NW * NW], const float (&v)[NW],
                                         float (&out)[NW]) {
#pragma unroll
  for (int a = 0; a < NW; ++a) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < NW; ++e) s += M[a * NW + e] * v[e];
    out[a] = s;
  }
}

// 16 one-warp blocks an SM: at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 16) alloc_kernel(
    const float* __restrict__ D,     // (6, 16) shared
    const float* __restrict__ w,     // (B, 6) commanded wrench
    const float* __restrict__ ff,    // (B, 6) stuck-on fault wrench
    const float* __restrict__ uub,   // (B, 16)
    const float* __restrict__ hA,    // (B, F, 6) masked hull rows
    const float* __restrict__ hb,    // (B, F)
    const float* __restrict__ G,     // (B, 6, 16) zonotope generators
    const float* __restrict__ c,     // (B, 6) zonotope center
    const float* __restrict__ step,  // (B,) 1 / Lipschitz constant
    const float* __restrict__ mt,    // (B,) max thrust
    float* __restrict__ u_out,       // (B, 16)
    float* __restrict__ wdes_out,    // (B, 6)
    float* __restrict__ flags_out,   // (B, 3): was_clipped, used_fallback, eq_err
    int B, int F, int fista_iters, int admm_iters, float rho,
    float rho_eq_scale, float sigma, float alpha) {
  __shared__ float hs[GROUPS][HSTRIDE];
  const int grp = threadIdx.x / NT;
  const int g = threadIdx.x % NT;     // this lane's thruster
  const int base = threadIdx.x - g;   // the group's first lane
  const int b = blockIdx.x * GROUPS + grp;
  // A group past the last scenario runs a copy of the last one and stores
  // nothing, so every shuffle and vote sees its whole warp.
  const bool live = b < B;
  const size_t bb = static_cast<size_t>(live ? b : B - 1);

  float Dc[NW], Gc[NW], wt[NW], ffb[NW], cb[NW];
#pragma unroll
  for (int a = 0; a < NW; ++a) {
    Dc[a] = D[a * NT + g];
    Gc[a] = G[(bb * NW + a) * NT + g];
    ffb[a] = ff[bb * NW + a];
    wt[a] = w[bb * NW + a] + ffb[a];
    cb[a] = c[bb * NW + a];
  }
  const float ub = uub[bb * NT + g];
  const float st = step[bb];
  const float max_thrust = mt[bb];

  // --- feasibility test against the hull: facets f = g + 16 m of each ----
  // pass of FCHUNK, staged through shared memory
  bool outside = false;
  for (int f0 = 0; f0 < F; f0 += FCHUNK) {
    const int nf = min(FCHUNK, F - f0);
    const float* src = hA + (bb * F + f0) * NW;
    float stage[SPL], hbf[FPL];
#pragma unroll
    for (int m = 0; m < SPL; ++m)
      stage[m] = (g + NT * m < nf * NW) ? src[g + NT * m] : 0.f;
#pragma unroll
    for (int m = 0; m < FPL; ++m)
      hbf[m] = (g + NT * m < nf) ? hb[bb * F + f0 + g + NT * m] : 0.f;
    __syncwarp(FULL);  // the previous pass has been read
#pragma unroll
    for (int m = 0; m < SPL; ++m)
      if (g + NT * m < nf * NW) hs[grp][g + NT * m] = stage[m];
    __syncwarp(FULL);
#pragma unroll
    for (int m = 0; m < FPL; ++m) {
      const int f = g + NT * m;
      if (f < nf) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < NW; ++i) s += hs[grp][f * NW + i] * wt[i];
        if (!(s <= hbf[m] + 1e-7f)) outside = true;
      }
    }
  }
  const unsigned group_bits = 0xffffu << base;
  const bool feasible = (__ballot_sync(FULL, outside) & group_bits) == 0u;

  // --- FISTA projection onto the zonotope --------------------------------
  float theta = 0.5f, eta = 0.5f, tk = 1.f;
  for (int it = 0; it < fista_iters; ++it) {
    float r[NW];
    cols_sum(Gc, eta, r);
#pragma unroll
    for (int i = 0; i < NW; ++i) r[i] = r[i] + cb[i] - wt[i];
    const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * tk * tk));
    const float mom = (tk - 1.f) / t_new;
    const float th = clip(eta - st * col_dot(Gc, r), 0.f, 1.f);
    eta = th + mom * (th - theta);
    theta = th;
    tk = t_new;
  }
  float w_des[NW];
  cols_sum(Gc, theta, w_des);
#pragma unroll
  for (int i = 0; i < NW; ++i) w_des[i] = (feasible ? wt[i] : cb[i] + w_des[i]) - ffb[i];
  const float u_fb = clip(theta * max_thrust, 0.f, ub);

  // --- allocation ADMM ---------------------------------------------------
  const float rho_eq = rho * rho_eq_scale;
  const float rho_box = (ub <= 1e-12f) ? rho * rho_eq_scale : rho;
  const float di = 1.f / (2.f + sigma + rho_box);
  float W[NW * NW], Winv[NW * NW];
  capacitance(Dc, di, 1.f / rho_eq, W);
  gauss_jordan6(W, Winv, g, base);

  float x = 0.f, z_box = 0.f, y_box = 0.f, y_eq[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) y_eq[i] = 0.f;
  // z_eq stays w_des: its projection interval is [w_des, w_des]
  for (int it = 0; it < admm_iters; ++it) {
    float v6[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) v6[i] = rho_eq * w_des[i] - y_eq[i];
    const float rhs = sigma * x + col_dot(Dc, v6) + (rho_box * z_box - y_box);
    // x~ = K^{-1} rhs by Woodbury
    const float tv = di * rhs;
    float s6[NW], r6[NW];
    cols_sum(Dc, tv, s6);
    mat6_vec(Winv, s6, r6);
    const float xt = tv - di * col_dot(Dc, r6);
    float Dx[NW];
    cols_sum(Dc, xt, Dx);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float zh_eq = alpha * Dx[i] + (1.f - alpha) * w_des[i];
      y_eq[i] = y_eq[i] + rho_eq * (zh_eq - w_des[i]);
    }
    const float zh_box = alpha * xt + (1.f - alpha) * z_box;
    const float zb = clip(zh_box + div_pos(y_box, rho_box), 0.f, ub);
    y_box = y_box + rho_box * (zh_box - zb);
    z_box = zb;
    x = alpha * xt + (1.f - alpha) * x;
  }

  // --- min-norm equality polish over healthy thrusters ---------------------
  float u = clip(x, 0.f, ub);
  const float healthy = (ub > 1e-12f) ? 1.f : 0.f;
  float r_eq[NW];
  cols_sum(Dc, u, r_eq);
#pragma unroll
  for (int i = 0; i < NW; ++i) r_eq[i] = w_des[i] - r_eq[i];
  capacitance(Dc, healthy, 1e-6f, W);
  gauss_jordan6(W, Winv, g, base);
  float lam[NW];
  mat6_vec(Winv, r_eq, lam);
  u = clip(u + healthy * col_dot(Dc, lam), 0.f, ub);

  float Du[NW], Dfb[NW];
  cols_sum(Dc, u, Du);
  cols_sum(Dc, u_fb, Dfb);
  float eq_err = 0.f, fb_err = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    eq_err = fmaxf(eq_err, fabsf(Du[i] - w_des[i]));
    fb_err = fmaxf(fb_err, fabsf(Dfb[i] - w_des[i]));
  }
  const bool use_fb = (eq_err > 1e-2f) && (fb_err < eq_err - 1e-9f);

  if (!live) return;
  u_out[bb * NT + g] = use_fb ? u_fb : u;
  const float flags[3] = {feasible ? 0.f : 1.f, use_fb ? 1.f : 0.f, use_fb ? fb_err : eq_err};
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if (g == i) wdes_out[bb * NW + i] = w_des[i];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (g == k) flags_out[bb * 3 + k] = flags[k];
}

}  // namespace

extern "C" int alloc_f32(const void* D, const void* w, const void* ff,
                         const void* uub, const void* hA, const void* hb,
                         const void* G, const void* c, const void* step,
                         const void* mt, void* u_out, void* wdes_out,
                         void* flags_out, int B, int F, int fista_iters,
                         int admm_iters, float rho, float rho_eq_scale,
                         float sigma, float alpha, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + GROUPS - 1) / GROUPS;
  alloc_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<const float*>(w),
      static_cast<const float*>(ff), static_cast<const float*>(uub),
      static_cast<const float*>(hA), static_cast<const float*>(hb),
      static_cast<const float*>(G), static_cast<const float*>(c),
      static_cast<const float*>(step), static_cast<const float*>(mt),
      static_cast<float*>(u_out), static_cast<float*>(wdes_out),
      static_cast<float*>(flags_out), B, F, fista_iters, admm_iters, rho,
      rho_eq_scale, sigma, alpha);
  return static_cast<int>(cudaGetLastError());
}
