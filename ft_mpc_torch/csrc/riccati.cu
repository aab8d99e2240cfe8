// Riccati re-solve sweeps of the stagewise (long-horizon) MPC QP.
//
// Replaces ft_mpc_tpu/solvers/lanes_riccati.py:_bwd_kernel and _fwd_kernel
// (wrapper lqr_resolve_lanes).  Against a fixed LQR factorization
// (F, B, K, Quu_inv, PC, c; n = 13 states, m = 6 inputs), per scenario b:
//
//   riccati_bwd_f32, t = Nt-1 .. 0, carry p seeded with qN:
//       w   = PC_t + p
//       k_t = Quu_inv_t (r_t + B_t' w)            -> ks[b, t]
//       p   = q_t + F_t' w - K_t' r_t
//   riccati_fwd_f32, t = 0 .. Nt-1, carry x seeded with x0 (X[b, 0] = x0):
//       u_t     = -K_t x - k_t                    -> U[b, t]
//       x       = F_t x + c_t - B_t k_t           -> X[b, t+1]
//
// All float32, batch-leading (B, Nt, ...) storage, row-major blocks.
//
// Bound on the H100: device-memory bytes (393 resp. 344 floats read and 6
// resp. 19 written per scenario-stage against ~700 flops), but what sets
// the time is latency: Nt dependent stages, each waiting on ~1.5 KB of
// factor blocks.  Design: one warp per scenario (one block of 32 threads),
// so the recursion needs no block barrier.  The stage's blocks stream from
// device memory into a ring of DEPTH shared-memory slots with cp.async,
// DEPTH - 1 stages ahead of the arithmetic, so the loads' latency overlaps
// the dependent chain.  The carry lives in registers (lane j holds entry j)
// and is broadcast through shared memory once per stage.  Row-major blocks
// in shared memory serve both product kinds without bank conflicts:
// transposed products (F'w, B'w, K'r) read consecutive addresses across
// lanes, plain ones (F x, K x, B k, Quu_inv v) read with strides 13 and 6,
// which are coprime with or spread over the 32 banks.  Terms that do not
// depend on the carry (K'r, B k) are summed first, off the critical path.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int NX = 13;
constexpr int NU = 6;
constexpr int WARP = 32;
constexpr int DEPTH = 4;       // ring slots: stages in flight
constexpr int U_LANE0 = 16;    // lanes 16..21 work on the 6 input rows
constexpr unsigned FULL = 0xffffffffu;

// slot layouts (floats)
constexpr int OFF_F = 0;
constexpr int OFF_B = OFF_F + NX * NX;
constexpr int OFF_K = OFF_B + NX * NU;
constexpr int BWD_QI = OFF_K + NU * NX;
constexpr int BWD_PC = BWD_QI + NU * NU;
constexpr int BWD_Q = BWD_PC + NX;
constexpr int BWD_R = BWD_Q + NX;
constexpr int BWD_SLOT = BWD_R + NU;   // 393
constexpr int FWD_C = OFF_K + NU * NX;
constexpr int FWD_KS = FWD_C + NX;
constexpr int FWD_SLOT = FWD_KS + NU;  // 344

// COUNT floats from device to shared memory, lane-strided; fully unrolled so
// that a stage's copies are a fixed run of cp.async instructions (one warp
// per scheduler hides no instruction latency: every instruction counts).
template <int COUNT>
__device__ __forceinline__ void copy_async(float* dst, const float* src, int lane) {
#pragma unroll
  for (int k = 0; k < (COUNT + WARP - 1) / WARP; ++k) {
    const int i = lane + k * WARP;
    if ((k + 1) * WARP <= COUNT || i < COUNT)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  }
}

__global__ void __launch_bounds__(WARP) riccati_bwd_kernel(
    const float* __restrict__ F,    // (B, Nt, 13, 13)
    const float* __restrict__ Bm,   // (B, Nt, 13, 6)
    const float* __restrict__ K,    // (B, Nt, 6, 13)
    const float* __restrict__ Qi,   // (B, Nt, 6, 6)
    const float* __restrict__ PC,   // (B, Nt, 13)
    const float* __restrict__ q,    // (B, Nt, 13)
    const float* __restrict__ r,    // (B, Nt, 6)
    const float* __restrict__ qN,   // (B, 13)
    float* __restrict__ ks,         // (B, Nt, 6)
    int Nt) {
  __shared__ float ring[DEPTH][BWD_SLOT];
  __shared__ float w_sh[NX];
  __shared__ float v_sh[NU];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * Nt;

  // sweep step s works on stage t = Nt - 1 - s
  auto prefetch = [&](int s) {
    const size_t st = base + (Nt - 1 - s);
    float* slot = ring[s % DEPTH];
    copy_async<NX * NX>(slot + OFF_F, F + st * NX * NX, lane);
    copy_async<NX * NU>(slot + OFF_B, Bm + st * NX * NU, lane);
    copy_async<NU * NX>(slot + OFF_K, K + st * NU * NX, lane);
    copy_async<NU * NU>(slot + BWD_QI, Qi + st * NU * NU, lane);
    copy_async<NX>(slot + BWD_PC, PC + st * NX, lane);
    copy_async<NX>(slot + BWD_Q, q + st * NX, lane);
    copy_async<NU>(slot + BWD_R, r + st * NU, lane);
  };
  for (int s = 0; s < DEPTH; ++s) {
    if (s < Nt) prefetch(s);
    __pipeline_commit();
  }

  float p = (lane < NX) ? qN[static_cast<size_t>(b) * NX + lane] : 0.f;
  for (int s = 0; s < Nt; ++s) {
    __pipeline_wait_prior(DEPTH - 1);  // this lane's copies of step s landed
    __syncwarp(FULL);                  // ... and every other lane's
    const float* slot = ring[s % DEPTH];
    const float* Fs = slot + OFF_F;
    const float* Bs = slot + OFF_B;
    const float* Ks = slot + OFF_K;
    const float* rs = slot + BWD_R;

    float p_base = 0.f;
    if (lane < NX) {
      w_sh[lane] = slot[BWD_PC + lane] + p;
      // q_j - (K' r)_j does not depend on the carry
      float kr = 0.f;
#pragma unroll
      for (int a = 0; a < NU; ++a) kr += Ks[a * NX + lane] * rs[a];
      p_base = slot[BWD_Q + lane] - kr;
    }
    __syncwarp(FULL);  // w visible
    if (lane < NX) {
      float acc0 = 0.f, acc1 = 0.f;  // (F' w)_j in two chains
#pragma unroll
      for (int i = 0; i + 1 < NX; i += 2) {
        acc0 += Fs[i * NX + lane] * w_sh[i];
        acc1 += Fs[(i + 1) * NX + lane] * w_sh[i + 1];
      }
      acc0 += Fs[(NX - 1) * NX + lane] * w_sh[NX - 1];
      p = p_base + (acc0 + acc1);
    } else if (lane >= U_LANE0 && lane < U_LANE0 + NU) {
      const int j = lane - U_LANE0;
      float acc0 = rs[j], acc1 = 0.f;  // r_j + (B' w)_j in two chains
#pragma unroll
      for (int i = 0; i + 1 < NX; i += 2) {
        acc0 += Bs[i * NU + j] * w_sh[i];
        acc1 += Bs[(i + 1) * NU + j] * w_sh[i + 1];
      }
      acc0 += Bs[(NX - 1) * NU + j] * w_sh[NX - 1];
      v_sh[j] = acc0 + acc1;
    }
    __syncwarp(FULL);  // v visible
    if (lane >= U_LANE0 && lane < U_LANE0 + NU) {
      const int a = lane - U_LANE0;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc += slot[BWD_QI + a * NU + c] * v_sh[c];
      ks[(base + (Nt - 1 - s)) * NU + a] = acc;
    }
    __syncwarp(FULL);  // slot, w and v are free again
    if (s + DEPTH < Nt) prefetch(s + DEPTH);
    __pipeline_commit();
  }
}

__global__ void __launch_bounds__(WARP) riccati_fwd_kernel(
    const float* __restrict__ F,    // (B, Nt, 13, 13)
    const float* __restrict__ Bm,   // (B, Nt, 13, 6)
    const float* __restrict__ c,    // (B, Nt, 13)
    const float* __restrict__ K,    // (B, Nt, 6, 13)
    const float* __restrict__ ks,   // (B, Nt, 6)
    const float* __restrict__ x0,   // (B, 13)
    float* __restrict__ X,          // (B, Nt + 1, 13)
    float* __restrict__ U,          // (B, Nt, 6)
    int Nt) {
  __shared__ float ring[DEPTH][FWD_SLOT];
  __shared__ float x_sh[NX];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * Nt;
  float* Xb = X + static_cast<size_t>(b) * (Nt + 1) * NX;

  auto prefetch = [&](int t) {
    const size_t st = base + t;
    float* slot = ring[t % DEPTH];
    copy_async<NX * NX>(slot + OFF_F, F + st * NX * NX, lane);
    copy_async<NX * NU>(slot + OFF_B, Bm + st * NX * NU, lane);
    copy_async<NU * NX>(slot + OFF_K, K + st * NU * NX, lane);
    copy_async<NX>(slot + FWD_C, c + st * NX, lane);
    copy_async<NU>(slot + FWD_KS, ks + st * NU, lane);
  };
  for (int t = 0; t < DEPTH; ++t) {
    if (t < Nt) prefetch(t);
    __pipeline_commit();
  }

  float x = 0.f;
  if (lane < NX) {
    x = x0[static_cast<size_t>(b) * NX + lane];
    Xb[lane] = x;
  }
  for (int t = 0; t < Nt; ++t) {
    __pipeline_wait_prior(DEPTH - 1);
    __syncwarp(FULL);
    const float* slot = ring[t % DEPTH];
    const float* Fs = slot + OFF_F;
    const float* Bs = slot + OFF_B;
    const float* Ks = slot + OFF_K;
    const float* kk = slot + FWD_KS;

    float x_base = 0.f;
    if (lane < NX) {
      x_sh[lane] = x;
      // c_i - (B k)_i does not depend on the carry
      float bk = 0.f;
#pragma unroll
      for (int a = 0; a < NU; ++a) bk += Bs[lane * NU + a] * kk[a];
      x_base = slot[FWD_C + lane] - bk;
    }
    __syncwarp(FULL);  // x visible
    if (lane < NX) {
      float acc0 = 0.f, acc1 = 0.f;  // (F x)_i in two chains
#pragma unroll
      for (int j = 0; j + 1 < NX; j += 2) {
        acc0 += Fs[lane * NX + j] * x_sh[j];
        acc1 += Fs[lane * NX + j + 1] * x_sh[j + 1];
      }
      acc0 += Fs[lane * NX + NX - 1] * x_sh[NX - 1];
      x = x_base + (acc0 + acc1);
      Xb[(t + 1) * NX + lane] = x;
    } else if (lane >= U_LANE0 && lane < U_LANE0 + NU) {
      const int a = lane - U_LANE0;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j) acc += Ks[a * NX + j] * x_sh[j];
      U[(base + t) * NU + a] = -acc - kk[a];
    }
    __syncwarp(FULL);  // slot and x_sh are free again
    if (t + DEPTH < Nt) prefetch(t + DEPTH);
    __pipeline_commit();
  }
}

}  // namespace

extern "C" int riccati_bwd_f32(const void* F, const void* Bm, const void* K,
                               const void* Qi, const void* PC, const void* q,
                               const void* r, const void* qN, void* ks, int B,
                               int Nt, void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  riccati_bwd_kernel<<<B, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      f(F), f(Bm), f(K), f(Qi), f(PC), f(q), f(r), f(qN), static_cast<float*>(ks), Nt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int riccati_fwd_f32(const void* F, const void* Bm, const void* c,
                               const void* K, const void* ks, const void* x0,
                               void* X, void* U, int B, int Nt, void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  riccati_fwd_kernel<<<B, WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      f(F), f(Bm), f(c), f(K), f(ks), f(x0), static_cast<float*>(X),
      static_cast<float*>(U), Nt);
  return static_cast<int>(cudaGetLastError());
}
