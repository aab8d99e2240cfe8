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
// Bounds on the H100 (fp32 outside the tensor cores at 67 TFLOP/s, HBM at
// 3.35 TB/s; the FLOP count of chip_smoke.py's admm_flops):
// - main path, B=2048, Nt=15, T=64, 60 iterations: ~51 kFLOP a
//   scenario-iteration, 6.3 GFLOP, ~0.106 ms, against ~120 MB of inputs
//   read once (~36 us);
// - with the state-box and rate rows, T=596 (same B, Nt, iterations):
//   ~230 kFLOP a scenario-iteration, 0.469 ms, against 440 MB of G_term
//   (214.6 KB a scenario) read once, 0.13 ms;
// - B=256, Nt=40, T=64, 60 iterations: ~225 kFLOP a scenario-iteration,
//   0.052 ms, against K^{-1} (230 KB a scenario, 59 MB) read once.
// Every operand is used every iteration, so what limits a design in
// practice is where the matrices are read from each iteration and how long
// the dependent chain of one iteration is.  No tensor cores: each
// iteration is a matrix-vector product per scenario with one right-hand
// side, and TF32 would break the float32 precision class that K's
// conditioning requires.
//
// admm_design picks one of three designs from the shape.
//
// 1. Registers (admm_reg_kernel; Nt <= 16, F <= 32, T <= 64, which holds
// the main path's Nt=15, F=32, T=64 and its cleanup): one block per
// scenario, one warp per two stages (a "slab" of 12 columns of x), up to 8
// warps.  The matrices live in registers for the whole launch: warp w holds
// rows 12w..12w+11 of K^{-1} (lane l: columns l, l+32, l+64; 36 floats) and
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
// Shared memory holds only rhs, x~ and the partial products (2.8 KB), and
// 128 registers a thread leave room for two blocks per SM.
//
// 2. Cluster (admm_cluster_kernel; every other shape whose K^{-1},
// G_term, hull state and vectors fit in the shared memory of a thread
// block cluster of C <= 8 blocks, C the least of 1, 2, 4, 8 that holds
// them: at F=32, T=64, C=1 to Nt=32, 2 to 42, 4 to 64, 8 to 85; at Nt=15,
// C=1 to T=459, 2 to 1027, 4 to 2147, 8 to 4291).  At T=596 (Nt=15) a
// scenario needs 262 KB and at Nt=40 (T=64) 313 KB: more than one block's
// 227 KB, so the first designs read G_term, or K^{-1} and G_term, from
// device memory every iteration (G_term twice: at T=596, B=2048 and 60
// iterations 52.7 GB, >= 15.7 ms of HBM time, of the 29.8 ms they took).
// Here the scenario stays on chip for the whole
// launch, as the TPU kernel keeps its block in VMEM: one cluster per
// scenario, and block c owns a contiguous run of whole stages (those rows
// of K^{-1}, those x entries and their hull facets, so the hull update
// stays local) and a contiguous slice of G_term's rows.  An iteration:
//   (a) each block forms its x~ entries, K^{-1} rows . rhs, with the rhs
//       summed from the cluster's partial vectors, and stores them into
//       every block's copy of x~ (st.async into distributed shared memory).
//   (b) x and the hull rows of the owned stages are updated from the
//       block's own x~; once the other blocks' x~ entries have arrived, one
//       pass over each owned G_term row: s_r = G_r . x~, the zt/yt update,
//       and G_r^T (rho zt_r - yt_r) added into the block's partial rhs (the
//       first designs' two passes over G_term, reordered, as the register
//       design does).  The warps' partials are summed with sigma x - g and
//       the hull's transpose on the owned entries, and the block's partial
//       rhs is stored into its slot in every block.
// Blocks exchange data without cluster barriers: x~ and the slots are
// double-buffered by iteration parity, and each buffer's mbarrier counts
// the bytes the other blocks' st.async complete on it (a cluster barrier
// would cost a GPU-scope fence every iteration).  Every dot
// product is spread over a group of 8, 16 or 32 lanes (by n; one float4
// of the row per lane and step, neighbouring lanes on neighbouring
// addresses, so no bank conflicts) and finished with shuffles, 32/group
// rows at a time; rows are padded to the layout so no load is masked.
// Each G_term row is read from shared memory once an iteration and stays
// in registers between its product and its transpose.  G_term and K^{-1}
// are staged with cp.async; 256 threads a block where two blocks fit on an
// SM, else 512.  A single-block cluster (C=1) exchanges nothing.  On an
// NVIDIA H100 80GB HBM3 at 700.00 W (kernel_ab.py): 5.86 ms at T=596,
// B=2048, 60 iterations (8.0% of its bound; the first design 29.56) and
// 1.19 ms at Nt=40, B=256 (4.3%; the device design 6.10).  What is left is
// the latency of each iteration's dependent chain, 3-5 us whether or not
// the cluster exchanges anything (C=1 at Nt=20, one wave: 4.7 us).
//
// 3. Device (admm_dev_kernel; beyond the largest cluster: Nt >= 86 at
// F=32, T=64, or T >= 4292 at Nt=15): one block a scenario
// with K^{-1} and G_term left in device memory and read through L2 every
// iteration; each warp takes rows of K^{-1} and reads a row with its 32
// lanes on neighbouring addresses, then sums across the warp.  The hull
// state (hh, zh, yh) and the vectors stay in shared memory; where the hull
// state does not fit either (Nt > ~470 at F=32, T=64) it is kept in the
// output arrays in device memory.  Simple and right, not fast: it took
// 6.10 ms at B=256, Nt=40 on an NVIDIA H100 80GB HBM3 at 700.00 W
// (kernel_ab.py), 0.85% of its bound, before the cluster design took that
// shape.
#include <cooperative_groups.h>

#include <type_traits>

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

// ---- cluster design ----
constexpr int CL_MAX = 8;               // portable cluster size
constexpr size_t SMEM_CAP = 232448;     // usable shared memory per block (227 KB)
constexpr size_t SMEM_PAIR = 115712;    // at most this, two blocks share an SM

// The lane-group layouts of the dot products: `group` lanes per row, each
// holding `chunks` float4 of it, so rows are padded to 4 * group * chunks
// floats (the least that holds n).  A warp takes 32 / group rows at a time.
struct ClusterLayout {
  int group, chunks;
};
constexpr ClusterLayout CL_LAYOUTS[] = {{8, 3}, {8, 4}, {16, 3}, {16, 4},
                                        {32, 3}, {32, 4}, {32, 5}};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Floats of dynamic shared memory a block of a C-block cluster of `warps`
// warps uses, rows padded to the layout: each block is sized for the
// largest share (ceil(Nt/C) stages, ceil(T/C) rows, counts rounded up to
// the rows a warp takes at a time).  x~ and the partial-rhs slots are
// double-buffered.
__host__ __device__ inline size_t cl_floats(int Nt, int F, int T, int C, int warps,
                                            ClusterLayout lay) {
  const size_t ld = 4 * lay.group * lay.chunks;
  const int rows = WARP / lay.group;
  const size_t ns = (Nt + C - 1) / C;
  const size_t ne = round_up(NU * ns, rows), nr = round_up((T + C - 1) / C, rows);
  return 8                                     // four mbarriers
         + (ne + nr) * ld                      // owned rows of K^{-1}, of G_term
         + (2 + 2 * C + warps) * ld            // x~ (2), slots (2 x C), the warps' partials
         + static_cast<size_t>(F) * NU         // Ah (transposed)
         + 3 * ns * F + 3 * NU * ns + 3 * nr;  // hh zh yh; x g hull part; ht zt yt
}

struct ClusterPlan {
  int C, group, chunks, threads;
  size_t smem;
};

// The least cluster (1, 2, 4, 8 blocks) whose shared memory holds the
// scenario, with the layout of least padding for its n; 256 threads a
// block where two such blocks fit on an SM (or only 256 fit), else 512.
// False where no cluster holds it.
bool cluster_plan(int Nt, int F, int T, ClusterPlan* p) {
  if (Nt < 1 || T < 0 || F < 0) return false;
  const int n = Nt * NU;
  const ClusterLayout* lay = nullptr;
  for (const ClusterLayout& l : CL_LAYOUTS)
    if (n <= 4 * l.group * l.chunks && (lay == nullptr || l.group * l.chunks < lay->group * lay->chunks))
      lay = &l;
  if (lay == nullptr) return false;
  for (int C = 1; C <= CL_MAX; C *= 2) {
    const size_t small = cl_floats(Nt, F, T, C, 8, *lay) * sizeof(float);
    const size_t large = cl_floats(Nt, F, T, C, 16, *lay) * sizeof(float);
    if (small > SMEM_CAP) continue;
    const bool pair = small <= SMEM_PAIR || large > SMEM_CAP;
    *p = {C, lay->group, lay->chunks, pair ? 256 : 512, pair ? small : large};
    return true;
  }
  return false;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The address of the same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive (the phase's one arrival) and expect `bytes` of st.async this phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Store into another block's shared memory, completing 4 (16) bytes on its mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Sum over the `G` lanes of a group (xor exchanges inside it); every lane
// of the group gets the total.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum each of v[0..5] over the warp in 8 shuffles: halving exchanges over
// lane bits 4, 2, 1 (the three entries left after bit 4 padded to four),
// then full ones over bits 3 and 0.  Lane l gets the total of entry
// 3 b4 + 2 b2 + b1 (its bits), valid where 2 b2 + b1 < 3.
__device__ __forceinline__ float reduce6(const float (&v)[NU], int lane) {
  const bool h4 = lane & 16, h2 = lane & 4, h1 = lane & 2;
  float u[4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    u[k] = (h4 ? v[k + 3] : v[k]) + __shfl_xor_sync(FULL, h4 ? v[k] : v[k + 3], 16);
  u[3] = 0.f;
  float p[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    p[k] = (h2 ? u[k + 2] : u[k]) + __shfl_xor_sync(FULL, h2 ? u[k] : u[k + 2], 4);
  float q = (h1 ? p[1] : p[0]) + __shfl_xor_sync(FULL, h1 ? p[0] : p[1], 2);
  q += __shfl_xor_sync(FULL, q, 8);
  return q + __shfl_xor_sync(FULL, q, 1);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float4 a, float w) {
  acc.x += a.x * w;
  acc.y += a.y * w;
  acc.z += a.z * w;
  acc.w += a.w * w;
}

__device__ __forceinline__ void add4(float4& acc, float4 a) {
  acc.x += a.x;
  acc.y += a.y;
  acc.z += a.z;
  acc.w += a.w;
}

// Sum each of the V values a lane holds over the warp's 32 / GS groups
// (lanes that differ in the bits from GS up) by halving exchanges: at each
// bit, lanes with the bit set keep the upper half of their values and send
// the lower, and the other way round.  Returns, in a[0 .. V*GS/32), the
// totals of the values base, base + 1, ... of the original order.
template <int GS, int V>
__device__ __forceinline__ int groups_reduce(float (&a)[V], int lane) {
  int base = 0;
#pragma unroll
  for (int o = WARP / 2, cnt = V / 2; o >= GS; o >>= 1, cnt >>= 1) {
    const bool h = lane & o;
#pragma unroll
    for (int k = 0; k < cnt; ++k)
      a[k] = (h ? a[k + cnt] : a[k]) + __shfl_xor_sync(FULL, h ? a[k] : a[k + cnt], o);
    if (h) base += cnt;
  }
  return base;
}

// GS lanes per row, lane gl of a group holding float4 chunks gl, gl+GS, ...
// (M of them) of the row; 32/GS rows a warp at a time; THREADS threads a
// block.  Rows are padded to ld = 4*GS*M floats and the row counts to
// 32/GS with zero rows whose z, y stay zero, so nothing in the loops is
// masked.
template <int GS, int M, int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS) admm_cluster_kernel(
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
  namespace cg = cooperative_groups;
  constexpr int WARPS = THREADS / WARP;
  constexpr int R = WARP / GS;       // rows a warp takes at a time
  constexpr int LD4 = GS * M;        // float4 a padded row
  constexpr int LD = 4 * LD4;
  constexpr int V = 4 * M;           // values of a row a lane holds
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / C;
  const int n = Nt * NU;
  const int ns_max = (Nt + C - 1) / C;
  const int ne_pad = round_up(NU * ns_max, R), nr_pad = round_up((T + C - 1) / C, R);
  const int t0 = c * Nt / C, ns = (c + 1) * Nt / C - t0;  // owned stages
  const int r0 = c * T / C, nr = (c + 1) * T / C - r0;    // owned G_term rows
  const int e0 = t0 * NU, ne = ns * NU;                   // owned entries of x
  const int tid = threadIdx.x, lane = tid & (WARP - 1), warp = tid / WARP;
  const int grp = lane / GS, gl = lane % GS;

  extern __shared__ float4 sm4[];
  // x~ of iteration k and the partial rhs of push j (formed before
  // iteration j) arrive in buffer k & 1, j & 1; each buffer's mbarrier
  // counts the bytes the other blocks send into it
  unsigned long long* mb_x = reinterpret_cast<unsigned long long*>(sm4);
  unsigned long long* mb_s = mb_x + 2;
  float4* Ks4 = sm4 + 2;                  // owned rows of K^{-1} (ne_pad)
  float4* Gs4 = Ks4 + ne_pad * LD4;       // owned rows of G_term (nr_pad)
  float4* xt4 = Gs4 + nr_pad * LD4;       // x~, two buffers (zero past n)
  float4* slot4 = xt4 + 2 * LD4;          // two buffers of C partial rhs, one per block
  float* wpart = reinterpret_cast<float*>(slot4 + 2 * C * LD4);  // the warps' partials
  float* AhT = wpart + WARPS * LD;        // AhT[j * F + f] = Ah[f][j]
  float* hh = AhT + F * NU;               // owned stages x F
  float* zh = hh + ns_max * F;
  float* yh = zh + ns_max * F;
  float* xs = yh + ns_max * F;            // owned entries of x, g, hull transpose
  float* gs = xs + NU * ns_max;
  float* hp = gs + NU * ns_max;
  float* ht = hp + NU * ns_max;           // owned rows of h_term, zt, yt (nr_pad)
  float* zt = ht + nr_pad;
  float* yt = zt + nr_pad;
  float* xt = reinterpret_cast<float*>(xt4);
  float* Ks = reinterpret_cast<float*>(Ks4);
  float* Gs = reinterpret_cast<float*>(Gs4);
  const unsigned xbytes = C > 1 ? 4u * (n - ne) : 0u, sbytes = 16u * (C - 1) * LD4;

  // stage the owned rows, padded with zeros: K^{-1} and G_term
  // asynchronously, the rest plainly
  const float* Kb = Kinv + (b * n + e0) * n;
  const float* Gb = G_term + (b * T + r0) * n;
  for (int r = warp; r < ne_pad; r += WARPS)
    for (int k = lane; k < LD; k += WARP) {
      if (r < ne && k < n) cp_async4(Ks + r * LD + k, Kb + static_cast<size_t>(r) * n + k);
      else Ks[r * LD + k] = 0.f;
    }
  for (int r = warp; r < nr_pad; r += WARPS)
    for (int k = lane; k < LD; k += WARP) {
      if (r < nr && k < n) cp_async4(Gs + r * LD + k, Gb + static_cast<size_t>(r) * n + k);
      else Gs[r * LD + k] = 0.f;
    }
  for (int i = tid; i < 2 * LD; i += THREADS) xt[i] = 0.f;
  for (int i = tid; i < F * NU; i += THREADS) {
    const int f = i / NU, j = i - f * NU;
    AhT[j * F + f] = hull_A[b * F * NU + i];
  }
  for (int i = tid; i < ns * F; i += THREADS) {
    const size_t src = (b * Nt + t0) * F + i;
    hh[i] = h_hull[src];
    zh[i] = zh0[src];
    yh[i] = yh0[src];
  }
  for (int i = tid; i < ne; i += THREADS) {
    xs[i] = x0[b * n + e0 + i];
    gs[i] = g[b * n + e0 + i];
  }
  for (int i = tid; i < nr_pad; i += THREADS) {  // padded rows: z = y = h = 0, inert
    const bool own = i < nr;
    ht[i] = own ? h_term[b * T + r0 + i] : 0.f;
    zt[i] = own ? zt0[b * T + r0 + i] : 0.f;
    yt[i] = own ? yt0[b * T + r0 + i] : 0.f;
  }
  const float rho = rho_in[b];
  const float inv_rho = 1.f / rho;
  const float beta = 1.f - alpha;
  // the terminal rows' prox without a branch: the hinge's shift when
  // elastic, else an infinite one (the same values as min(v, h))
  const bool elastic = y_max > 0.f;
  const float shift = elastic ? y_max * inv_rho : INFINITY;
  if (C > 1 && tid == 0) {
    for (int q = 0; q < 2; ++q) {
      mbar_init(&mb_x[q]);
      mbar_init(&mb_s[q]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first phases: pushes 0 and 1, x~ of iterations 0 and 1
    for (int q = 0; q < 2 && q < iters; ++q) {
      mbar_expect(&mb_s[q], sbytes);
      if (xbytes > 0) mbar_expect(&mb_x[q], xbytes);
    }
  }
  cp_async_wait_all();
  // every block's mbarriers are armed before any block stores into it
  if (C > 1) cluster.sync();
  else __syncthreads();

  if (iters > 0) {
    // (b) of iteration `it` (it < 0: before the first): with `update`, the
    // hull and terminal rows' z, y updates from x~; then push it + 1, the
    // block's partial rhs, into every block's slot c (none after the last
    // iteration).
    auto partial_rhs = [&](auto update_tag, int it) {
      constexpr bool update = decltype(update_tag)::value;
      const float* xc = xt + (it & 1) * LD;
      for (int s = warp; s < ns; s += WARPS) {  // hull rows: a warp a stage (own x~)
        const float* xs_t = xc + e0 + s * NU;
        float part[NU] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int f = lane; f < F; f += WARP) {
          const int idx = s * F + f;
          float z = zh[idx], y = yh[idx];
          if constexpr (update) {
            float gh = 0.f;
#pragma unroll
            for (int j = 0; j < NU; ++j) gh += AhT[j * F + f] * xs_t[j];
            const float zhat = alpha * gh + beta * z;
            const float znew = fminf(zhat + y * inv_rho, hh[idx]);
            y = y + rho * (zhat - znew);
            z = znew;
            zh[idx] = z;
            yh[idx] = y;
          }
          const float v = rho * z - y;
#pragma unroll
          for (int j = 0; j < NU; ++j) part[j] += AhT[j * F + f] * v;
        }
        const float tot = reduce6(part, lane);
        const int e = 3 * ((lane >> 4) & 1) + 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
        if ((lane & 9) == 0 && (lane & 6) != 6) hp[s * NU + e] = tot;
      }

      // terminal rows: one read of each owned row, kept in registers between
      // s_r = G_r . x~ and G_r^T (rho zt_r - yt_r)
      if constexpr (update) {
        // the other blocks' x~ entries (none where the block owns every
        // stage: an empty phase would complete as it is armed, before every
        // thread has seen the last one)
        if (xbytes > 0) {
          const int q = it & 1;
          mbar_wait(&mb_x[q], (it >> 1) & 1);
          if (tid == 0 && it + 2 < iters) mbar_expect(&mb_x[q], xbytes);
        }
      }
      const float4* xc4 = xt4 + (it & 1) * LD4;
      float4 xv[M], acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        xv[m] = update ? xc4[gl + GS * m] : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 2
      for (int r = warp * R + grp; r < nr_pad; r += WARPS * R) {
        const float4* row = Gs4 + r * LD4 + gl;
        float4 gv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) gv[m] = row[GS * m];
        float z = zt[r], y = yt[r];
        if constexpr (update) {
          float sr = 0.f;
#pragma unroll
          for (int m = 0; m < M; ++m) sr += dot4(gv[m], xv[m]);
          sr = group_sum<GS>(sr);  // after the reads of zt[r], yt[r] above
          const float zhat = alpha * sr + beta * z;
          const float v = zhat + y * inv_rho;
          const float hr = ht[r];
          const float znew = (v > hr + shift) ? v - shift : fminf(v, hr);
          const float ynew = y + rho * (zhat - znew);
          y = elastic ? fminf(fmaxf(ynew, 0.f), y_max) : ynew;
          z = znew;
          if (gl == 0) {
            zt[r] = z;
            yt[r] = y;
          }
        }
        const float w = rho * z - y;
#pragma unroll
        for (int m = 0; m < M; ++m) fma4(acc[m], gv[m], w);
      }
      // the warp's R groups summed by halving, into this warp's partial
      float a[V];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        a[4 * m] = acc[m].x;
        a[4 * m + 1] = acc[m].y;
        a[4 * m + 2] = acc[m].z;
        a[4 * m + 3] = acc[m].w;
      }
      const int base = groups_reduce<GS, V>(a, lane);
#pragma unroll
      for (int k = 0; k < V * GS / WARP; ++k) {
        const int idx = base + k;  // value idx of lane gl: chunk idx / 4, component idx % 4
        wpart[warp * LD + 4 * (gl + GS * (idx >> 2)) + (idx & 3)] = a[k];
      }
      __syncthreads();

      // the block's partial rhs, a float4 a thread: the warps' sum, and on
      // the owned entries sigma x - g and the hull transpose (x relaxed first)
      const int j = it + 1;  // the push
      for (int q = tid; q < LD4; q += THREADS) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) add4(v, reinterpret_cast<const float4*>(wpart)[w * LD4 + q]);
        float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = 4 * q + k - e0;
          if (o >= 0 && o < ne) {
            float xi = xs[o];
            if constexpr (update) {
              xi = alpha * xc[e0 + o] + beta * xi;
              xs[o] = xi;
            }
            vv[k] += sigma * xi - gs[o] + hp[o];
          }
        }
        if (j < iters) {
          v = make_float4(vv[0], vv[1], vv[2], vv[3]);
          float4* dst = slot4 + ((j & 1) * C + c) * LD4 + q;
          *dst = v;
          for (int rk = 1; rk < C; ++rk) {
            const unsigned peer = (c + rk) % C;
            st_async4(mapa(smem_addr(dst), peer), v, mapa(smem_addr(&mb_s[j & 1]), peer));
          }
        }
      }
      __syncthreads();
    };

    partial_rhs(std::false_type{}, -1);
    for (int it = 0; it < iters; ++it) {
      // (a) the owned entries of x~ = K^{-1} rhs, into every block's x~
      const int q = it & 1;
      if (C > 1) {
        mbar_wait(&mb_s[q], (it >> 1) & 1);  // the other blocks' partial rhs
        if (tid == 0 && it + 2 < iters) mbar_expect(&mb_s[q], sbytes);
      }
      float* xq = xt + q * LD;
      if (warp * R < ne_pad) {
        const float4* sl4 = slot4 + q * C * LD4 + gl;
        float4 rv[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          rv[m] = sl4[GS * m];
          for (int rk = 1; rk < C; ++rk) add4(rv[m], sl4[rk * LD4 + GS * m]);
        }
        for (int i = warp * R + grp; i < ne_pad; i += WARPS * R) {
          const float4* row = Ks4 + i * LD4 + gl;
          float s = 0.f;
#pragma unroll
          for (int m = 0; m < M; ++m) s += dot4(row[GS * m], rv[m]);
          s = group_sum<GS>(s);
          if (i < ne && gl == 0) {
            xq[e0 + i] = s;
            for (int rk = 1; rk < C; ++rk) {
              const unsigned peer = (c + rk) % C;
              st_async(mapa(smem_addr(xq + e0 + i), peer), s, mapa(smem_addr(&mb_x[q]), peer));
            }
          }
        }
      }
      __syncthreads();
      // (b) relaxation, hull and terminal rows, the next partial rhs
      partial_rhs(std::true_type{}, it);
    }
  }

  for (int i = tid; i < ne; i += THREADS) x_out[b * n + e0 + i] = xs[i];
  for (int i = tid; i < ns * F; i += THREADS) {
    const size_t dst = (b * Nt + t0) * F + i;
    zh_out[dst] = zh[i];
    yh_out[dst] = yh[i];
  }
  for (int i = tid; i < nr; i += THREADS) {
    zt_out[b * T + r0 + i] = zt[i];
    yt_out[b * T + r0 + i] = yt[i];
  }
}

// ---- device-memory design, beyond the largest cluster ----
constexpr int DEV_THREADS = 256;

__host__ __device__ inline size_t admm_dev_floats(int Nt, int F, int T, bool hull_shared) {
  const size_t n = static_cast<size_t>(Nt) * NU;
  size_t s = static_cast<size_t>(F) * NU + 4 * n + 3 * T;
  if (hull_shared) s += 3 * static_cast<size_t>(Nt) * (F + 1);
  return s;
}

// K^{-1} and G_term stay in device memory.  With hull_shared the hull
// arrays are staged in shared memory with stride F+1, free of bank
// conflicts; with 0, hh is read from h_hull and zh, yh live in zh_out,
// yh_out.
__global__ void __launch_bounds__(DEV_THREADS) admm_dev_kernel(
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
    float alpha, int iters, float y_max, int hull_shared) {
  extern __shared__ float sm[];
  const int n = Nt * NU;
  const int H = Nt * F;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t bn = static_cast<size_t>(b);

  float* Ah = sm;                    // F*6
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

  const float* Kb = Kinv + bn * n * n;
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
  const float* Gt = G_term + bn * T * n;
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
        acc += Gt[r * n + i] * (rho * zt[r] - yt[r]);
      rhs[i] = sigma * x[i] - gv[i] + acc;
    }
    __syncthreads();
    // (2) x~ = K^{-1} rhs: a warp a row, lanes along it
    for (int i = warp; i < n; i += nwarps) {
      const float* Ki = Kb + static_cast<size_t>(i) * n;
      float part = 0.f;
      for (int k = lane; k < n; k += 32) part += Ki[k] * rhs[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) xt[i] = part;
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
      for (int i = lane; i < n; i += 32) part += Gt[r * n + i] * xt[i];
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

using ClusterKernel = decltype(&admm_cluster_kernel<8, 3, 256>);

template <int THREADS>
ClusterKernel cluster_kernel_of(const ClusterPlan& p) {
  switch (p.group * 8 + p.chunks) {
    case 8 * 8 + 3: return admm_cluster_kernel<8, 3, THREADS>;
    case 8 * 8 + 4: return admm_cluster_kernel<8, 4, THREADS>;
    case 16 * 8 + 3: return admm_cluster_kernel<16, 3, THREADS>;
    case 16 * 8 + 4: return admm_cluster_kernel<16, 4, THREADS>;
    case 32 * 8 + 3: return admm_cluster_kernel<32, 3, THREADS>;
    case 32 * 8 + 4: return admm_cluster_kernel<32, 4, THREADS>;
    default: return admm_cluster_kernel<32, 5, THREADS>;
  }
}

ClusterKernel cluster_kernel(const ClusterPlan& p) {
  return p.threads == 256 ? cluster_kernel_of<256>(p) : cluster_kernel_of<512>(p);
}

cudaLaunchConfig_t cluster_config(const ClusterPlan& p, int B, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * p.C);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int design_of(int Nt, int F, int T, ClusterPlan* p) {
  if (admm_fits_registers(Nt, F, T)) return 0;
  if (cluster_plan(Nt, F, T, p)) return 1;
  if (admm_dev_floats(Nt, F, T, false) * sizeof(float) <= SMEM_CAP) return 2;
  return -1;
}

}  // namespace

// The design admm_f32 runs at these sizes: 0 registers (admm_reg_kernel),
// 1 cluster (admm_cluster_kernel), 2 device memory (admm_dev_kernel), -1
// none (shared memory too small even for the vectors; n above ~14,000).
extern "C" int admm_design(int Nt, int F, int T) {
  ClusterPlan p;
  return design_of(Nt, F, T, &p);
}

// The design (as admm_design) and, in out[0..5]: the blocks a scenario
// takes (its cluster size; 1 outside the cluster design), the dynamic
// shared memory of a block in bytes, the cluster design's lanes per row,
// float4 a lane holds of a row and threads a block, and
// cudaOccupancyMaxActiveClusters for a launch of that shape (cluster
// design, else 0).  out[6] is the CUDA error of that query.
extern "C" int admm_plan(int Nt, int F, int T, int* out) {
  ClusterPlan p = {1, 0, 0, 0, 0};
  const int design = design_of(Nt, F, T, &p);
  for (int i = 0; i < 7; ++i) out[i] = 0;
  out[0] = 1;
  if (design == 2) {
    const bool hull_shared = admm_dev_floats(Nt, F, T, true) * sizeof(float) <= SMEM_CAP;
    out[1] = static_cast<int>(admm_dev_floats(Nt, F, T, hull_shared) * sizeof(float));
    out[4] = DEV_THREADS;
  }
  if (design != 1) return design;
  out[0] = p.C;
  out[1] = static_cast<int>(p.smem);
  out[2] = p.group;
  out[3] = p.chunks;
  out[4] = p.threads;
  const ClusterKernel kernel = cluster_kernel(p);
  cudaError_t err = ftmpc_allow_smem(kernel, p.smem);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(p, 1, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(&out[5], kernel, &cfg);
  }
  out[6] = static_cast<int>(err);
  return design;
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
  ClusterPlan p;
  const int design = design_of(Nt, F, T, &p);
  if (design == 0) {
    const int warps = (Nt + 1) / 2;  // two stages per warp
    admm_reg_kernel<<<B, warps * WARP, 0, st>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], Nt, F, T, sigma,
        alpha, iters, y_max);
    return static_cast<int>(cudaGetLastError());
  }
  if (design == 1) {
    const ClusterKernel kernel = cluster_kernel(p);
    cudaError_t err = ftmpc_allow_smem(kernel, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(p, B, st, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, in[0], in[1], in[2], in[3], in[4], in[5],
                             in[6], in[7], in[8], in[9], in[10], in[11], out[0], out[1],
                             out[2], out[3], out[4], Nt, F, T, sigma, alpha, iters, y_max);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (design == 2) {
    const int hull_shared =
        admm_dev_floats(Nt, F, T, true) * sizeof(float) <= SMEM_CAP ? 1 : 0;
    const size_t smem = admm_dev_floats(Nt, F, T, hull_shared != 0) * sizeof(float);
    cudaError_t err = ftmpc_allow_smem(admm_dev_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    admm_dev_kernel<<<B, DEV_THREADS, smem, st>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        in[10], in[11], out[0], out[1], out[2], out[3], out[4], Nt, F, T, sigma,
        alpha, iters, y_max, hull_shared);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
