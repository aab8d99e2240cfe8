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
// exactly symmetric, so symmetry is never assumed.
//
// Bound on the H100: fp32 FMAs.  ~51 kFLOP per scenario-iteration at
// T=64 (K^{-1} matvec 8.1k FMA, two passes over G_term 11.5k, hull block
// 5.8k), 6.3 GFLOP for B=2048 x 60 iterations, ~94 us at 67 TFLOP/s,
// against ~120 MB of inputs read once (~36 us).  Every operand is re-read
// every iteration, so the first limit met in practice is the shared-memory
// read per FMA, not HBM.
// Design: one block per scenario; K^{-1} (32.4 KB at n=90) and all ADMM
// state stay in shared memory for the whole launch, so HBM is touched once
// per input and output.  K^{-1} is stored transposed so that in the matvec
// neighbouring threads (rows i) read neighbouring addresses.  G_term is
// copied to shared memory with an odd row stride (n+1) when it fits beside
// K^{-1} (T=64: 23 KB); with state-box and rate rows (T up to ~600, 214 KB)
// it is read from global memory with the same access pattern, coalesced.
// The hull arrays use an odd stride (F+1) to keep the per-stage reads free
// of bank conflicts.
#include "common.cuh"

namespace {

constexpr int NU = 6;
constexpr int THREADS = 256;
constexpr size_t SMEM_CAP = 232448;  // usable shared memory per block (227 KB)

__host__ __device__ inline size_t admm_smem_floats(int Nt, int F, int T,
                                                   bool gt_shared) {
  const size_t n = static_cast<size_t>(Nt) * NU;
  const size_t H = static_cast<size_t>(Nt) * (F + 1);
  size_t s = n * n + static_cast<size_t>(F) * NU + 3 * H + 4 * n + 3 * T;
  if (gt_shared) s += static_cast<size_t>(T) * (n + 1);
  return s;
}

__global__ void __launch_bounds__(THREADS) admm_kernel(
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
    float alpha, int iters, float y_max, int gt_shared) {
  extern __shared__ float sm[];
  const int n = Nt * NU;
  const int ldh = F + 1;
  const int H = Nt * F;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  float* KT = sm;                    // n*n, KT[k*n + i] = Kinv[i][k]
  float* Ah = KT + n * n;            // F*6
  float* hh = Ah + F * NU;           // Nt*(F+1)
  float* zh = hh + Nt * ldh;         // Nt*(F+1)
  float* yh = zh + Nt * ldh;         // Nt*(F+1)
  float* gv = yh + Nt * ldh;         // n
  float* x = gv + n;                 // n
  float* rhs = x + n;                // n
  float* xt = rhs + n;               // n
  float* ht = xt + n;                // T
  float* zt = ht + T;                // T
  float* yt = zt + T;                // T
  float* Gs = yt + T;                // T*(n+1) when gt_shared

  const size_t bn = static_cast<size_t>(b);
  const float* Kb = Kinv + bn * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    KT[k * n + i] = Kb[idx];
  }
  for (int idx = tid; idx < F * NU; idx += blockDim.x)
    Ah[idx] = hull_A[bn * F * NU + idx];
  for (int idx = tid; idx < H; idx += blockDim.x) {
    const int t = idx / F;
    const int f = idx - t * F;
    const size_t src = bn * H + idx;
    hh[t * ldh + f] = h_hull[src];
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
    for (int i = tid; i < n; i += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc += KT[k * n + i] * rhs[k];
      xt[i] = acc;
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
  for (int idx = tid; idx < H; idx += blockDim.x) {
    const int t = idx / F;
    const int f = idx - t * F;
    zh_out[bn * H + idx] = zh[t * ldh + f];
    yh_out[bn * H + idx] = yh[t * ldh + f];
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

extern "C" int admm_f32(const void* Kinv, const void* hull_A,
                        const void* h_hull, const void* G_term,
                        const void* h_term, const void* g, const void* x0,
                        const void* zh0, const void* zt0, const void* yh0,
                        const void* yt0, const void* rho, void* x_out,
                        void* zh_out, void* zt_out, void* yh_out, void* yt_out,
                        int B, int Nt, int F, int T, float sigma, float alpha,
                        int iters, float y_max, void* stream) {
  if (B <= 0) return 0;
  const int gt_shared = admm_gt_shared(Nt, F, T);
  const size_t smem = admm_smem_floats(Nt, F, T, gt_shared != 0) * sizeof(float);
  if (smem > SMEM_CAP) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ftmpc_allow_smem(admm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Kinv), static_cast<const float*>(hull_A),
      static_cast<const float*>(h_hull), static_cast<const float*>(G_term),
      static_cast<const float*>(h_term), static_cast<const float*>(g),
      static_cast<const float*>(x0), static_cast<const float*>(zh0),
      static_cast<const float*>(zt0), static_cast<const float*>(yh0),
      static_cast<const float*>(yt0), static_cast<const float*>(rho),
      static_cast<float*>(x_out), static_cast<float*>(zh_out),
      static_cast<float*>(zt_out), static_cast<float*>(yh_out),
      static_cast<float*>(yt_out), Nt, F, T, sigma, alpha, iters, y_max,
      gt_shared);
  return static_cast<int>(cudaGetLastError());
}
