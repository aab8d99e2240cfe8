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
// ~100 dependent iterations per scenario, so it is latency-bound.
// Design: one thread per scenario, whole problem in registers (16 thrusters,
// 6 wrench rows, 6x6 inverses fully unrolled), the shared 6x16 thruster map
// D in shared memory; no synchronisation inside the iteration chains.
#include "common.cuh"

namespace {

constexpr int NW = 6;
constexpr int NT = 16;
constexpr int THREADS = 128;

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Inverse of an SPD 6x6 by Gauss-Jordan without pivoting (same elimination
// order as _gauss_jordan6: every row is updated from the pre-step matrix).
__device__ __forceinline__ void gauss_jordan6(const float W[NW * NW],
                                              float Winv[NW * NW]) {
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
    float piv[2 * NW];
    const float dp = aug[p][p];
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) piv[j] = aug[p][j] / dp;
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

__device__ __forceinline__ void d_mul(const float* Ds, const float v[NT],
                                      float out[NW]) {
#pragma unroll
  for (int a = 0; a < NW; ++a) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) s += Ds[a * NT + j] * v[j];
    out[a] = s;
  }
}

__device__ __forceinline__ void dt_mul(const float* Ds, const float v[NW],
                                       float out[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < NW; ++a) s += Ds[a * NT + j] * v[a];
    out[j] = s;
  }
}

__global__ void __launch_bounds__(THREADS) alloc_kernel(
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
  __shared__ float Ds[NW * NT];
  for (int i = threadIdx.x; i < NW * NT; i += blockDim.x) Ds[i] = D[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t bb = static_cast<size_t>(b);

  float wt[NW], ffb[NW], cb[NW], ub[NT], Gb[NW * NT];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    ffb[i] = ff[bb * NW + i];
    wt[i] = w[bb * NW + i] + ffb[i];
    cb[i] = c[bb * NW + i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) ub[j] = uub[bb * NT + j];
#pragma unroll
  for (int k = 0; k < NW * NT; ++k) Gb[k] = G[bb * NW * NT + k];
  const float st = step[b];
  const float max_thrust = mt[b];

  // --- feasibility test against the hull ---------------------------------
  bool feasible = true;
  for (int f = 0; f < F; ++f) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) s += hA[(bb * F + f) * NW + j] * wt[j];
    if (!(s <= hb[bb * F + f] + 1e-7f)) feasible = false;
  }

  // --- FISTA projection onto the zonotope --------------------------------
  float theta[NT], eta[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) theta[j] = eta[j] = 0.5f;
  float tk = 1.f;
  for (int it = 0; it < fista_iters; ++it) {
    float r[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) s += Gb[i * NT + j] * eta[j];
      r[i] = s + cb[i] - wt[i];
    }
    const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * tk * tk));
    const float mom = (tk - 1.f) / t_new;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float gr = 0.f;
#pragma unroll
      for (int i = 0; i < NW; ++i) gr += Gb[i * NT + j] * r[i];
      const float th = clip(eta[j] - st * gr, 0.f, 1.f);
      eta[j] = th + mom * (th - theta[j]);
      theta[j] = th;
    }
    tk = t_new;
  }
  float w_des[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) s += Gb[i * NT + j] * theta[j];
    const float w_proj = cb[i] + s;
    w_des[i] = (feasible ? wt[i] : w_proj) - ffb[i];
  }
  float u_fb[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) u_fb[j] = clip(theta[j] * max_thrust, 0.f, ub[j]);

  // --- allocation ADMM ---------------------------------------------------
  const float rho_eq = rho * rho_eq_scale;
  float rho_box[NT], di[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    rho_box[j] = (ub[j] <= 1e-12f) ? rho * rho_eq_scale : rho;
    di[j] = 1.f / (2.f + sigma + rho_box[j]);
  }
  float W[NW * NW], Winv[NW * NW];
#pragma unroll
  for (int a = 0; a < NW; ++a) {
#pragma unroll
    for (int e = 0; e < NW; ++e) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) s += Ds[a * NT + j] * Ds[e * NT + j] * di[j];
      W[a * NW + e] = ((a == e) ? 1.f : 0.f) / rho_eq + s;
    }
  }
  gauss_jordan6(W, Winv);

  float x[NT], z_box[NT], y_box[NT], y_eq[NW];
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j] = z_box[j] = y_box[j] = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) y_eq[i] = 0.f;
  // z_eq stays w_des: its projection interval is [w_des, w_des]
  for (int it = 0; it < admm_iters; ++it) {
    float v6[NW], tmp[NT], rhs[NT];
#pragma unroll
    for (int i = 0; i < NW; ++i) v6[i] = rho_eq * w_des[i] - y_eq[i];
    dt_mul(Ds, v6, tmp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      rhs[j] = sigma * x[j] + tmp[j] + (rho_box[j] * z_box[j] - y_box[j]);
    // x~ = K^{-1} rhs by Woodbury
    float tv[NT], s6[NW], r6[NW], xt[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) tv[j] = di[j] * rhs[j];
    d_mul(Ds, tv, s6);
#pragma unroll
    for (int a = 0; a < NW; ++a) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < NW; ++e) s += Winv[a * NW + e] * s6[e];
      r6[a] = s;
    }
    dt_mul(Ds, r6, tmp);
#pragma unroll
    for (int j = 0; j < NT; ++j) xt[j] = tv[j] - di[j] * tmp[j];
    float Dx[NW];
    d_mul(Ds, xt, Dx);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float zh_eq = alpha * Dx[i] + (1.f - alpha) * w_des[i];
      y_eq[i] = y_eq[i] + rho_eq * (zh_eq - w_des[i]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float zh_box = alpha * xt[j] + (1.f - alpha) * z_box[j];
      const float zb = clip(zh_box + y_box[j] / rho_box[j], 0.f, ub[j]);
      y_box[j] = y_box[j] + rho_box[j] * (zh_box - zb);
      z_box[j] = zb;
      x[j] = alpha * xt[j] + (1.f - alpha) * x[j];
    }
  }

  // --- min-norm equality polish over healthy thrusters ---------------------
  float u[NT], healthy[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    u[j] = clip(x[j], 0.f, ub[j]);
    healthy[j] = (ub[j] > 1e-12f) ? 1.f : 0.f;
  }
  float Du[NW], r_eq[NW];
  d_mul(Ds, u, Du);
#pragma unroll
  for (int i = 0; i < NW; ++i) r_eq[i] = w_des[i] - Du[i];
#pragma unroll
  for (int a = 0; a < NW; ++a) {
#pragma unroll
    for (int e = 0; e < NW; ++e) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) s += Ds[a * NT + j] * Ds[e * NT + j] * healthy[j];
      W[a * NW + e] = 1e-6f * ((a == e) ? 1.f : 0.f) + s;
    }
  }
  gauss_jordan6(W, Winv);
  float lam[NW], corr[NT];
#pragma unroll
  for (int a = 0; a < NW; ++a) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < NW; ++e) s += Winv[a * NW + e] * r_eq[e];
    lam[a] = s;
  }
  dt_mul(Ds, lam, corr);
#pragma unroll
  for (int j = 0; j < NT; ++j) u[j] = clip(u[j] + healthy[j] * corr[j], 0.f, ub[j]);

  float Dfb[NW];
  d_mul(Ds, u, Du);
  d_mul(Ds, u_fb, Dfb);
  float eq_err = 0.f, fb_err = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    eq_err = fmaxf(eq_err, fabsf(Du[i] - w_des[i]));
    fb_err = fmaxf(fb_err, fabsf(Dfb[i] - w_des[i]));
  }
  const bool use_fb = (eq_err > 1e-2f) && (fb_err < eq_err - 1e-9f);

#pragma unroll
  for (int j = 0; j < NT; ++j) u_out[bb * NT + j] = use_fb ? u_fb[j] : u[j];
#pragma unroll
  for (int i = 0; i < NW; ++i) wdes_out[bb * NW + i] = w_des[i];
  flags_out[bb * 3 + 0] = feasible ? 0.f : 1.f;
  flags_out[bb * 3 + 1] = use_fb ? 1.f : 0.f;
  flags_out[bb * 3 + 2] = use_fb ? fb_err : eq_err;
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
  const int blocks = (B + THREADS - 1) / THREADS;
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
