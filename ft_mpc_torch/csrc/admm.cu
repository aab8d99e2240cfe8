// Fused ADMM iterations for the condensed MPC QP with a fixed K^{-1}.
//
// Replaces ft_mpc_tpu/solvers/lanes_qp.py:_admm_kernel (wrapper admm_lanes,
// driven per phase by solve_mpc_qp_lanes).  Per scenario, `iters`
// over-relaxed iterations of
//   x~   = K^{-1} (sigma x - g + (I_Nt (x) Ah)^T (rho zh - yh) + Gt^T (rho zt - yt))
//   x    = alpha x~ + (1 - alpha) x
//   zh^  = alpha (I (x) Ah) x~ + (1 - alpha) zh,   zt^ = alpha Gt x~ + (1 - alpha) zt
//   zh   = min(zh^ + yh / rho, hh)
//   zt   = min(zt^ + yt / rho, ht), or the exact hinge prox when elastic
//   yh  += rho (zh^ - zh),  yt += rho (zt^ - zt)  (yt clamped to [0, y_max])
// with the stage hull block implicit and one rho per scenario.  K^{-1} is
// used as given (row i dotted with rhs): exact_kinv's output is not
// exactly symmetric, so symmetry is never assumed.  The products keep this
// association: nothing is folded (no K^{-1} Gt^T), since K's condition
// number is about 1e5.
//
// Bound on the H100: fp32 FMAs.  ~51 kFLOP per scenario-iteration at
// T=64 (K^{-1} matvec 8.1k FMA, two passes over G_term 11.5k, hull block
// 5.8k), 6.3 GFLOP for B=2048 x 60 iterations, ~94 us at 67 TFLOP/s,
// against ~120 MB of inputs read once (~36 us).  Every operand is used
// every iteration, so what limits a design in practice is where the
// matrices are read from each iteration and how long the dependent chain
// of one iteration is.  No tensor cores: each iteration is a matrix-vector
// product per scenario with one right-hand side, and TF32 would break the
// float32 precision class that K's conditioning requires.
//
// Design (admm_reg_kernel; Nt <= 16, F <= 32, T <= 64, which holds the main
// path's Nt=15, F=32, T=64 and its cleanup): one block per scenario, one
// warp per two stages (a "slab" of 12 columns of x), up to 8 warps.  The
// matrices live in registers for the whole launch: warp w holds rows
// 12w..12w+11 of K^{-1} (lane l: columns l, l+32, l+64; 36 floats) and
// columns 12w..12w+11 of G_term (lane l: rows l, l+32; 24 floats), and lane
// f holds hull facet f (Ah row, hh/zh/yh of the slab's two stages).  Every
// thread works in every phase, and an iteration has two block barriers:
//   K: x~ on the slab's rows = K^{-1} rows . rhs (rhs read from shared
//      memory), 3 FMAs per lane and value, then a transpose-reduce of the
//      12 row sums across the warp (13 shuffles; each lane keeps its K^{-1}
//      rows in the order the first two exchanges consume them, so those
//      need no selects); x~ reaches every lane of the warp through 12
//      floats of shared memory; x and the slab's hull rows are updated in
//      registers, and the slab's part of G_term x~ (64 rows over 12
//      columns) goes to shared memory.  | barrier
//   R: every warp sums the 8 partial G_term x~ and updates all zt, yt in
//      registers (an identical copy in each warp), then forms the slab's
//      rhs entries: G_term^T (rho zt - yt) and the hull transpose over its
//      own register tiles, reduced across the warp the same way, and
//      written to shared memory.  | barrier
// Shared memory holds only rhs, x~ and the partial products (2.8 KB), and 128
// registers a thread leave room for two blocks per SM.
//
// Other shapes (more stages, facets or terminal rows, such as T=596 with
// the state-box and rate rows) run admm_smem_kernel, the first design:
// K^{-1} and, where it fits beside it, G_term in shared memory; otherwise
// G_term is read from device memory every iteration.
//
// Where K^{-1} does not fit in shared memory (Nt >= 39 at F=32, T=64) the
// same kernel runs with K^{-1} and G_term left in device memory and read
// through L2 every iteration, one block a scenario (admm_smem_kernel<false>,
// the "device-memory design"): each warp takes rows of K^{-1} and reads a
// row with its 32 lanes on neighbouring addresses, then sums across the
// warp.  The hull state (hh, zh, yh) and the vectors stay in shared memory
// as in the first design; where the hull state does not fit either
// (Nt > ~470 at F=32, T=64) it is kept in the output arrays in device memory.
// Bound at B=256, Nt=40, T=64, 60 iterations: ~225 kFLOP a
// scenario-iteration, 3.45 GFLOP, ~52 us at 67 TFLOP/s, against 59 MB of
// K^{-1} read once (~18 us); read 60 times it is ~3.5 GB, which is what a
// block that cannot hold K^{-1} pays where the resident blocks' K^{-1}
// outgrow the 50 MB L2.  It takes 6.1 ms on an H100 SXM at 700 W
// (chip_smoke.py): each warp reads its rows one after another, so the
// design is simple and right, not fast.
#include "common.cuh"

namespace {

constexpr int NU = 6;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// ---- register-tiled kernel ----
constexpr int SLAB = 2 * NU;                 // columns of x per warp (two stages)
constexpr int REG_WARPS = 8;
constexpr int REG_NMAX = SLAB * REG_WARPS;   // 96: Nt <= 16
constexpr int REG_KCOLS = REG_NMAX / WARP;   // columns of K^{-1} per lane
constexpr int REG_TMAX = 64;                 // terminal rows
constexpr int REG_TROWS = REG_TMAX / WARP;   // rows of G_term per lane
constexpr int REG_FMAX = WARP;               // one facet per lane

// The last exchanges of the slab reductions below: w holds three partial
// totals (padded to four) over lanes that differ in bits 2, 1, 0.
__device__ __forceinline__ float slab_reduce_tail(float (&w)[4], int lane) {
  const bool h2 = lane & 4, h1 = lane & 2;
  w[3] = 0.f;
  float p[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    p[k] = (h2 ? w[k + 2] : w[k]) + __shfl_xor_sync(FULL, h2 ? w[k] : w[k + 2], 4);
  const float q = (h1 ? p[1] : p[0]) + __shfl_xor_sync(FULL, h1 ? p[0] : p[1], 2);
  return q + __shfl_xor_sync(FULL, q, 1);
}

// Sum each of v[0..11] over the warp's 32 lanes.  Returns, in lane l, the
// total of entry slab_index(l) (lanes with index -1 get 0): halving
// exchanges over lane bits 4, 3, 2, 1 (the three entries left after bit 3
// padded to four), then one full exchange over bit 0.  13 shuffles.
__device__ __forceinline__ float slab_reduce(const float (&v)[SLAB], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  float u[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    u[k] = (h4 ? v[k + 6] : v[k]) + __shfl_xor_sync(FULL, h4 ? v[k] : v[k + 6], 16);
  float w[4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    w[k] = (h3 ? u[k + 3] : u[k]) + __shfl_xor_sync(FULL, h3 ? u[k] : u[k + 3], 8);
  return slab_reduce_tail(w, lane);
}

// slab_reduce for partial sums kept in the lane's own order: v[p] is entry
// slab_row(p, lane), so the first two halving exchanges need no selects.
// Leaves the same entry in the same lane as slab_reduce.
__device__ __forceinline__ float slab_reduce_own(const float (&v)[SLAB], int lane) {
  float u[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) u[k] = v[k] + __shfl_xor_sync(FULL, v[k + 6], 16);
  float w[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = u[k] + __shfl_xor_sync(FULL, u[k + 3], 8);
  return slab_reduce_tail(w, lane);
}

// The slab entry at position p of the lane's own order: the halves and the
// quarters swapped in lanes whose bit 4 and bit 3 are set.
__device__ __forceinline__ int slab_row(int p, int lane) {
  return 6 * ((p / 6) ^ ((lane >> 4) & 1)) + 3 * (((p % 6) / 3) ^ ((lane >> 3) & 1)) + p % 3;
}

// The slab entry whose total slab_reduce leaves in `lane`, or -1.
__device__ __forceinline__ int slab_index(int lane) {
  const int k = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
  return k < 3 ? 6 * ((lane >> 4) & 1) + 3 * ((lane >> 3) & 1) + k : -1;
}

__global__ void __launch_bounds__(REG_WARPS * WARP, 2) admm_reg_kernel(
    const float* __restrict__ Kinv,    // (B, n, n)
    const float* __restrict__ hull_A,  // (B, F, 6)
    const float* __restrict__ h_hull,  // (B, Nt, F)
    const float* __restrict__ G_term,  // (B, T, n)
    const float* __restrict__ h_term,  // (B, T)
    const float* __restrict__ g,       // (B, n)
    const float* __restrict__ x0,      // (B, n)
    const float* __restrict__ zh0,     // (B, Nt, F)
    const float* __restrict__ zt0,     // (B, T)
    const float* __restrict__ yh0,     // (B, Nt, F)
    const float* __restrict__ yt0,     // (B, T)
    const float* __restrict__ rho_in,  // (B,)
    float* __restrict__ x_out, float* __restrict__ zh_out,
    float* __restrict__ zt_out, float* __restrict__ yh_out,
    float* __restrict__ yt_out, int Nt, int F, int T, float sigma,
    float alpha, int iters, float y_max) {
  __shared__ float rhs_s[REG_NMAX];
  __shared__ float gpart[REG_WARPS][REG_TMAX];  // per warp: its slab's G_term x~
  __shared__ __align__(16) float xt_s[REG_WARPS][16];  // per warp: x~ on its slab
  const int n = Nt * NU;
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const int col0 = warp * SLAB;
  const size_t b = blockIdx.x;

  // register tiles, zero outside the problem so padding stays inert
  float kt[SLAB][REG_KCOLS];  // K^{-1}[col0 + slab_row(p)][lane + 32 m]
  const float* Kb = Kinv + b * n * n;
#pragma unroll
  for (int p = 0; p < SLAB; ++p)
#pragma unroll
    for (int m = 0; m < REG_KCOLS; ++m) {
      const int i = col0 + slab_row(p, lane), k = lane + WARP * m;
      kt[p][m] = (i < n && k < n) ? Kb[i * n + k] : 0.f;
    }
  float gt[REG_TROWS][SLAB];  // G_term[lane + 32 m][col0 + c]
  const float* Gb = G_term + b * T * n;
#pragma unroll
  for (int m = 0; m < REG_TROWS; ++m)
#pragma unroll
    for (int c = 0; c < SLAB; ++c) {
      const int r = lane + WARP * m, i = col0 + c;
      gt[m][c] = (r < T && i < n) ? Gb[r * n + i] : 0.f;
    }
  float ah[NU];  // facet `lane` of the hull block
#pragma unroll
  for (int j = 0; j < NU; ++j) ah[j] = lane < F ? hull_A[(b * F + lane) * NU + j] : 0.f;
  float hh[2], zh[2], yh[2];  // facet `lane` at the slab's stages 2w, 2w+1
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = 2 * warp + s;
    const bool ok = lane < F && t < Nt;
    const size_t idx = (b * Nt + t) * F + lane;
    hh[s] = ok ? h_hull[idx] : 0.f;
    zh[s] = ok ? zh0[idx] : 0.f;
    yh[s] = ok ? yh0[idx] : 0.f;
  }
  float ht[REG_TROWS], zt[REG_TROWS], yt[REG_TROWS];  // rows lane + 32 m
#pragma unroll
  for (int m = 0; m < REG_TROWS; ++m) {
    const int r = lane + WARP * m;
    ht[m] = r < T ? h_term[b * T + r] : 0.f;
    zt[m] = r < T ? zt0[b * T + r] : 0.f;
    yt[m] = r < T ? yt0[b * T + r] : 0.f;
  }
  const int ci = slab_index(lane);  // slab entry this lane keeps x and g of
  const int xi = col0 + ci;
  const bool xown = ci >= 0 && xi < n;
  float x = xown ? x0[b * n + xi] : 0.f;
  const float gv = xown ? g[b * n + xi] : 0.f;
  const float rho = rho_in[b];
  const float inv_rho = 1.f / rho;
  const float beta = 1.f - alpha;

  for (int i = threadIdx.x; i < REG_NMAX; i += blockDim.x) rhs_s[i] = 0.f;
  // partial products of absent warps stay zero, so every sum runs over 8
  for (int i = threadIdx.x; i < REG_WARPS * REG_TMAX; i += blockDim.x)
    gpart[i / REG_TMAX][i % REG_TMAX] = 0.f;
  __syncthreads();

  // R: the slab's rhs entries from x (updated) and the current z, y
  auto make_rhs = [&]() {
    float part[SLAB];
    const float v0 = rho * zh[0] - yh[0], v1 = rho * zh[1] - yh[1];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      part[j] = ah[j] * v0;
      part[NU + j] = ah[j] * v1;
    }
#pragma unroll
    for (int m = 0; m < REG_TROWS; ++m) {
      const float wm = rho * zt[m] - yt[m];
#pragma unroll
      for (int c = 0; c < SLAB; ++c) part[c] += gt[m][c] * wm;
    }
    const float sum = slab_reduce(part, lane);
    if (xown && !(lane & 1)) rhs_s[xi] = sigma * x - gv + sum;
  };

  make_rhs();
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // K: x~ on the slab, x and hull rows, partial G_term x~
    {
      const float r0 = rhs_s[lane], r1 = rhs_s[lane + WARP], r2 = rhs_s[lane + 2 * WARP];
      float part[SLAB];
#pragma unroll
      for (int p = 0; p < SLAB; ++p) part[p] = kt[p][0] * r0 + kt[p][1] * r1 + kt[p][2] * r2;
      const float xt_own = slab_reduce_own(part, lane);
      if (xown) x = alpha * xt_own + beta * x;
      if (ci >= 0 && !(lane & 1)) xt_s[warp][ci] = xt_own;  // zero past n
      __syncwarp();
      float xt[SLAB];
#pragma unroll
      for (int q = 0; q < SLAB / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(xt_s[warp])[q];
        xt[4 * q] = v.x;
        xt[4 * q + 1] = v.y;
        xt[4 * q + 2] = v.z;
        xt[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float gh = 0.f;
#pragma unroll
        for (int j = 0; j < NU; ++j) gh += ah[j] * xt[NU * s + j];
        const float zhat = alpha * gh + beta * zh[s];
        const float znew = fminf(zhat + yh[s] * inv_rho, hh[s]);
        yh[s] = yh[s] + rho * (zhat - znew);
        zh[s] = znew;
      }
#pragma unroll
      for (int m = 0; m < REG_TROWS; ++m) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < SLAB; ++c) p += gt[m][c] * xt[c];
        gpart[warp][lane + WARP * m] = p;
      }
    }
    __syncthreads();
    // R: terminal rows (every warp, identically), then the next rhs
#pragma unroll
    for (int m = 0; m < REG_TROWS; ++m) {
      const int r = lane + WARP * m;
      float gx = 0.f;
#pragma unroll
      for (int w = 0; w < REG_WARPS; ++w) gx += gpart[w][r];
      const float zhat = alpha * gx + beta * zt[m];
      const float v = zhat + yt[m] * inv_rho;
      float znew;
      if (y_max > 0.f) {
        const float shift = y_max * inv_rho;
        znew = (v > ht[m] + shift) ? v - shift : fminf(v, ht[m]);
      } else {
        znew = fminf(v, ht[m]);
      }
      float ynew = yt[m] + rho * (zhat - znew);
      if (y_max > 0.f) ynew = fminf(fmaxf(ynew, 0.f), y_max);
      zt[m] = znew;
      yt[m] = ynew;
    }
    if (it + 1 < iters) make_rhs();
    __syncthreads();
  }

  if (xown && !(lane & 1)) x_out[b * n + xi] = x;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = 2 * warp + s;
    if (lane < F && t < Nt) {
      const size_t idx = (b * Nt + t) * F + lane;
      zh_out[idx] = zh[s];
      yh_out[idx] = yh[s];
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < REG_TROWS; ++m) {
      const int r = lane + WARP * m;
      if (r < T) {
        zt_out[b * T + r] = zt[m];
        yt_out[b * T + r] = yt[m];
      }
    }
  }
}

bool admm_fits_registers(int Nt, int F, int T) {
  return Nt >= 1 && Nt * NU <= REG_NMAX && F <= REG_FMAX && T <= REG_TMAX;
}

// ---- shared-memory kernel (the first design), for the other shapes ----
constexpr int SMEM_THREADS = 256;
constexpr size_t SMEM_CAP = 232448;  // usable shared memory per block (227 KB)

__host__ __device__ inline size_t admm_smem_floats(int Nt, int F, int T,
                                                   bool gt_shared) {
  const size_t n = static_cast<size_t>(Nt) * NU;
  const size_t H = static_cast<size_t>(Nt) * (F + 1);
  size_t s = n * n + static_cast<size_t>(F) * NU + 3 * H + 4 * n + 3 * T;
  if (gt_shared) s += static_cast<size_t>(T) * (n + 1);
  return s;
}

__host__ __device__ inline size_t admm_gmem_floats(int Nt, int F, int T,
                                                   bool hull_shared) {
  const size_t n = static_cast<size_t>(Nt) * NU;
  size_t s = static_cast<size_t>(F) * NU + 4 * n + 3 * T;
  if (hull_shared) s += 3 * static_cast<size_t>(Nt) * (F + 1);
  return s;
}

// With kKinvShared, K^{-1} is stored transposed so that in the matvec
// neighbouring threads (rows i) read neighbouring addresses; G_term is
// staged with an odd row stride (n+1), and the hull arrays with stride F+1,
// free of bank conflicts.  Without it, K^{-1} and G_term stay in device
// memory (gt_shared is 0), and with hull_shared 0 so do hh, zh and yh:
// hh is read from h_hull and zh, yh live in zh_out, yh_out.
template <bool kKinvShared>
__global__ void __launch_bounds__(SMEM_THREADS) admm_smem_kernel(
    const float* __restrict__ Kinv,    // (B, n, n)
    const float* __restrict__ hull_A,  // (B, F, 6)
    const float* __restrict__ h_hull,  // (B, Nt, F)
    const float* __restrict__ G_term,  // (B, T, n)
    const float* __restrict__ h_term,  // (B, T)
    const float* __restrict__ g,       // (B, n)
    const float* __restrict__ x0,      // (B, n)
    const float* __restrict__ zh0,     // (B, Nt, F)
    const float* __restrict__ zt0,     // (B, T)
    const float* __restrict__ yh0,     // (B, Nt, F)
    const float* __restrict__ yt0,     // (B, T)
    const float* __restrict__ rho_in,  // (B,)
    float* __restrict__ x_out, float* __restrict__ zh_out,
    float* __restrict__ zt_out, float* __restrict__ yh_out,
    float* __restrict__ yt_out, int Nt, int F, int T, float sigma,
    float alpha, int iters, float y_max, int gt_shared, int hull_shared) {
  extern __shared__ float sm[];
  const int n = Nt * NU;
  const int H = Nt * F;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t bn = static_cast<size_t>(b);

  float* KT = sm;                    // n*n, KT[k*n + i] = Kinv[i][k] (kKinvShared)
  float* Ah = kKinvShared ? KT + n * n : sm;  // F*6
  float* sh = Ah + F * NU;           // 3*Nt*(F+1) when hull_shared
  const int ldh = hull_shared ? F + 1 : F;
  const float* hh = hull_shared ? sh : h_hull + bn * H;           // Nt*ldh
  float* zh = hull_shared ? sh + Nt * ldh : zh_out + bn * H;      // Nt*ldh
  float* yh = hull_shared ? sh + 2 * Nt * ldh : yh_out + bn * H;  // Nt*ldh
  float* gv = hull_shared ? sh + 3 * Nt * ldh : sh;  // n
  float* x = gv + n;                 // n
  float* rhs = x + n;                // n
  float* xt = rhs + n;               // n
  float* ht = xt + n;                // T
  float* zt = ht + T;                // T
  float* yt = zt + T;                // T
  float* Gs = yt + T;                // T*(n+1) when gt_shared

  const float* Kb = Kinv + bn * n * n;
  if (kKinvShared) {
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n;
      const int k = idx - i * n;
      KT[k * n + i] = Kb[idx];
    }
  }
  for (int idx = tid; idx < F * NU; idx += blockDim.x)
    Ah[idx] = hull_A[bn * F * NU + idx];
  for (int idx = tid; idx < H; idx += blockDim.x) {
    const int t = idx / F;
    const int f = idx - t * F;
    const size_t src = bn * H + idx;
    if (hull_shared) sh[t * ldh + f] = h_hull[src];
    zh[t * ldh + f] = zh0[src];
    yh[t * ldh + f] = yh0[src];
  }
  for (int i = tid; i < n; i += blockDim.x) {
    gv[i] = g[bn * n + i];
    x[i] = x0[bn * n + i];
  }
  for (int r = tid; r < T; r += blockDim.x) {
    ht[r] = h_term[bn * T + r];
    zt[r] = zt0[bn * T + r];
    yt[r] = yt0[bn * T + r];
  }
  const float* Gg = G_term + bn * T * n;
  const float* Gt = Gg;
  int ldg = n;
  if (gt_shared) {
    for (int idx = tid; idx < T * n; idx += blockDim.x) {
      const int r = idx / n;
      const int i = idx - r * n;
      Gs[r * (n + 1) + i] = Gg[idx];
    }
    Gt = Gs;
    ldg = n + 1;
  }
  const float rho = rho_in[b];
  const float inv_rho = 1.f / rho;
  const float beta = 1.f - alpha;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // (1) right-hand side; x is the previous iterate here
    for (int i = tid; i < n; i += blockDim.x) {
      const int t = i / NU;
      const int j = i - t * NU;
      float acc = 0.f;
      for (int f = 0; f < F; ++f)
        acc += Ah[f * NU + j] * (rho * zh[t * ldh + f] - yh[t * ldh + f]);
      for (int r = 0; r < T; ++r)
        acc += Gt[r * ldg + i] * (rho * zt[r] - yt[r]);
      rhs[i] = sigma * x[i] - gv[i] + acc;
    }
    __syncthreads();
    // (2) x~ = K^{-1} rhs
    if (kKinvShared) {
      for (int i = tid; i < n; i += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) acc += KT[k * n + i] * rhs[k];
        xt[i] = acc;
      }
    } else {
      for (int i = warp; i < n; i += nwarps) {  // a warp a row, lanes along it
        const float* Ki = Kb + static_cast<size_t>(i) * n;
        float part = 0.f;
        for (int k = lane; k < n; k += 32) part += Ki[k] * rhs[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) xt[i] = part;
      }
    }
    __syncthreads();
    // (3) relaxation, z projections, dual ascent
    for (int i = tid; i < n; i += blockDim.x) x[i] = alpha * xt[i] + beta * x[i];
    for (int idx = tid; idx < H; idx += blockDim.x) {
      const int t = idx / F;
      const int f = idx - t * F;
      float gh = 0.f;
#pragma unroll
      for (int j = 0; j < NU; ++j) gh += Ah[f * NU + j] * xt[t * NU + j];
      const int s = t * ldh + f;
      const float zhat = alpha * gh + beta * zh[s];
      const float znew = fminf(zhat + yh[s] * inv_rho, hh[s]);
      yh[s] = yh[s] + rho * (zhat - znew);
      zh[s] = znew;
    }
    for (int r = warp; r < T; r += nwarps) {
      float part = 0.f;
      for (int i = lane; i < n; i += 32) part += Gt[r * ldg + i] * xt[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const float zhat = alpha * part + beta * zt[r];
        const float v = zhat + yt[r] * inv_rho;
        float znew;
        if (y_max > 0.f) {
          const float shift = y_max * inv_rho;
          znew = (v > ht[r] + shift) ? v - shift : fminf(v, ht[r]);
        } else {
          znew = fminf(v, ht[r]);
        }
        float ynew = yt[r] + rho * (zhat - znew);
        if (y_max > 0.f) ynew = fminf(fmaxf(ynew, 0.f), y_max);
        zt[r] = znew;
        yt[r] = ynew;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += blockDim.x) x_out[bn * n + i] = x[i];
  if (hull_shared) {  // else zh, yh are already in place
    for (int idx = tid; idx < H; idx += blockDim.x) {
      const int t = idx / F;
      const int f = idx - t * F;
      zh_out[bn * H + idx] = zh[t * ldh + f];
      yh_out[bn * H + idx] = yh[t * ldh + f];
    }
  }
  for (int r = tid; r < T; r += blockDim.x) {
    zt_out[bn * T + r] = zt[r];
    yt_out[bn * T + r] = yt[r];
  }
}

// 1 when G_term is staged in shared memory at these sizes, else 0.
int admm_gt_shared(int Nt, int F, int T) {
  return admm_smem_floats(Nt, F, T, true) * sizeof(float) <= SMEM_CAP ? 1 : 0;
}

}  // namespace

// The design admm_f32 runs at these sizes: 0 registers (admm_reg_kernel),
// 1 K^{-1} in shared memory (admm_smem_kernel<true>), 2 K^{-1} in device
// memory (admm_smem_kernel<false>), -1 none (shared memory too small even
// for the vectors; n above ~14,000).
extern "C" int admm_design(int Nt, int F, int T) {
  if (admm_fits_registers(Nt, F, T)) return 0;
  if (admm_smem_floats(Nt, F, T, false) * sizeof(float) <= SMEM_CAP) return 1;
  if (admm_gmem_floats(Nt, F, T, false) * sizeof(float) <= SMEM_CAP) return 2;
  return -1;
}

extern "C" int admm_f32(const void* Kinv, const void* hull_A,
                        const void* h_hull, const void* G_term,
                        const void* h_term, const void* g, const void* x0,
                        const void* zh0, const void* zt0, const void* yh0,
                        const void* yt0, const void* rho, void* x_out,
                        void* zh_out, void* zt_out, void* yh_out, void* yt_out,
                        int B, int Nt, int F, int T, float sigma, float alpha,
                        int iters, float y_max, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in[12] = {
      static_cast<const float*>(Kinv), static_cast<const float*>(hull_A),
      static_cast<const float*>(h_hull), static_cast<const float*>(G_term),
      static_cast<const float*>(h_term), static_cast<const float*>(g),
      static_cast<const float*>(x0), static_cast<const float*>(zh0),
      static_cast<const float*>(zt0), static_cast<const float*>(yh0),
      static_cast<const float*>(yt0), static_cast<const float*>(rho)};
  float* out[5] = {static_cast<float*>(x_out), static_cast<float*>(zh_out),
                   static_cast<float*>(zt_out), static_cast<float*>(yh_out),
                   static_cast<float*>(yt_out)};
  const int design = admm_design(Nt, F, T);
  if (design == 0) {
    const int warps = (Nt + 1) / 2;  // two stages per warp
    admm_reg_kernel<<<B, warps * WARP, 0, st>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], Nt, F, T, sigma,
        alpha, iters, y_max);
    return static_cast<int>(cudaGetLastError());
  }
  if (design == 1) {
    const int gt_shared = admm_gt_shared(Nt, F, T);
    const size_t smem = admm_smem_floats(Nt, F, T, gt_shared != 0) * sizeof(float);
    cudaError_t err = ftmpc_allow_smem(admm_smem_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    admm_smem_kernel<true><<<B, SMEM_THREADS, smem, st>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], Nt, F, T, sigma,
        alpha, iters, y_max, gt_shared, 1);
    return static_cast<int>(cudaGetLastError());
  }
  if (design == 2) {
    const int hull_shared =
        admm_gmem_floats(Nt, F, T, true) * sizeof(float) <= SMEM_CAP ? 1 : 0;
    const size_t smem = admm_gmem_floats(Nt, F, T, hull_shared != 0) * sizeof(float);
    cudaError_t err = ftmpc_allow_smem(admm_smem_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    admm_smem_kernel<false><<<B, SMEM_THREADS, smem, st>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], Nt, F, T, sigma,
        alpha, iters, y_max, 0, hull_shared);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
