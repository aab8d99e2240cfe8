// Condensing kernel: prediction matrices of the condensed MPC QP.
//
// Replaces ft_mpc_tpu/solvers/lanes_condense.py:_condense_kernel (wrapper
// condense_lanes).  For each scenario b and stage t = 0..Nt-1:
//     S_t   = A_t S_{t-1},  then  S_t[:, 6t:6t+6] += B_t
//     phi_t = A_t phi_{t-1} + d_t
// with S_{-1} = 0, phi_{-1} = 0; S_t is (13, 6 Nt), all float32.
//
// Bound on the H100: device-memory bytes.  The kernel writes S_all,
// B * Nt * 13 * 6Nt floats (144 MB at B=2048, Nt=15), against ~0.9 GFLOP
// of FMAs: ~43 us of HBM traffic at 3.35 TB/s versus ~14 us of fp32 math.
// Design: the columns of S are independent recursions, so one thread owns
// two neighbouring columns c, c+1 of one scenario and keeps their 13-entry
// carries in registers for all Nt stages; one extra thread per scenario
// (c = n) carries phi.
// Nothing of the carry goes through shared memory and no barrier guards it.
// S is causal: column c of S_t is zero for c >= 6(t+1) and equals B_t's
// column exactly in block t (A_t times a zero column is zero for finite
// inputs), so only columns c < 6t do the 13x13 product; the others store
// B_t or zeros (6t is even, so both columns of a thread fall on the same
// side).  A block covers up to 512 columns of one scenario (several
// blocks for long horizons, each walking every stage), and reads A, B and
// d with cp.async into a ring of DEPTH stages in shared memory, DEPTH - 1
// stages ahead of the stage it computes: one barrier per stage (one stage
// ahead, each stage waited on its read: 52% of the byte bound against 57%
// with eight).  A_t sits in shared memory with rows padded to 16 floats, so
// a thread reads a row in four broadcast loads (three 16-byte ones) and
// uses it for both columns.  S_t is written
// row by row with 8-byte stores (rows of 6Nt floats start 8-byte aligned),
// neighbouring threads on neighbouring column pairs: each warp store is 256
// contiguous bytes.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int NX = 13;
constexpr int NU = 6;
constexpr int WARP = 32;
constexpr int MAX_THREADS = 256;               // column pairs per block at most
constexpr int LDA = 16;                        // padded row of A_t in shared memory
constexpr int OFF_B = NX * LDA;                // B_t (13 x 6, row-major)
constexpr int OFF_D = OFF_B + NX * NU;         // d_t
constexpr int SLOT = (OFF_D + NX + 3) / 4 * 4; // one stage, a multiple of 16 bytes
constexpr int STAGE_FLOATS = NX * NX + NX * NU + NX;
constexpr int DEPTH = 8;                       // stages in the copy ring

__global__ void __launch_bounds__(MAX_THREADS) condense_kernel(
    const float* __restrict__ A,    // (B, Nt, 13, 13)
    const float* __restrict__ Bm,   // (B, Nt, 13, 6)
    const float* __restrict__ d,    // (B, Nt, 13)
    float* __restrict__ S_out,      // (B, Nt, 13, 6Nt)
    float* __restrict__ phi_out,    // (B, Nt, 13)
    int Nt, int chunks) {
  __shared__ __align__(16) float ring[DEPTH * SLOT];
  const int n = Nt * NU;
  const int b = blockIdx.x / chunks;
  const int tid = threadIdx.x;
  // first of the thread's two columns; c == n carries phi
  const int c = 2 * ((blockIdx.x - b * chunks) * blockDim.x + tid);
  const size_t base = static_cast<size_t>(b) * Nt;

  // stage t's copies, committed as one group (an empty one past Nt, so
  // every thread counts DEPTH - 1 groups in flight)
  auto prefetch = [&](int t) {
    const size_t st = base + t;
    float* slot = ring + (t % DEPTH) * SLOT;
    for (int i = tid; t < Nt && i < STAGE_FLOATS; i += blockDim.x) {
      const float* src;
      float* dst;
      if (i < NX * NX) {
        src = A + st * NX * NX + i;
        dst = slot + (i / NX) * LDA + i % NX;
      } else if (i < NX * NX + NX * NU) {
        src = Bm + st * NX * NU + (i - NX * NX);
        dst = slot + OFF_B + (i - NX * NX);
      } else {
        src = d + st * NX + (i - NX * NX - NX * NU);
        dst = slot + OFF_D + (i - NX * NX - NX * NU);
      }
      __pipeline_memcpy_async(dst, src, sizeof(float));
    }
    __pipeline_commit();
  };

  float s[NX], s1[NX];  // columns c, c+1 of S_{t-1}; phi_{t-1} in s for c == n
#pragma unroll
  for (int k = 0; k < NX; ++k) s[k] = s1[k] = 0.f;

  for (int t = 0; t < DEPTH - 1; ++t) prefetch(t);
  for (int t = 0; t < Nt; ++t) {
    __pipeline_wait_prior(DEPTH - 2);
    __syncthreads();  // stage t landed for all; nobody reads stage t-1's slot
    prefetch(t + DEPTH - 1);  // into stage t-1's slot
    const float* slot = ring + (t % DEPTH) * SLOT;
    const int c0 = t * NU;
    const size_t st = base + t;
    if (c < c0 || c == n) {
      float nw[NX], nw1[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float4* row = reinterpret_cast<const float4*>(slot + i * LDA);
        const float4 a0 = row[0], a1 = row[1], a2 = row[2];
        const float a[NX] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w,
                             a2.x, a2.y, a2.z, a2.w, slot[i * LDA + 12]};
        float acc = a[0] * s[0], acc1 = a[0] * s1[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) {
          acc += a[k] * s[k];
          acc1 += a[k] * s1[k];
        }
        nw[i] = acc;
        nw1[i] = acc1;
      }
      if (c == n) {
#pragma unroll
        for (int i = 0; i < NX; ++i) nw[i] += slot[OFF_D + i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        s[i] = nw[i];
        s1[i] = nw1[i];
      }
    } else if (c < c0 + NU) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        s[i] = slot[OFF_B + i * NU + (c - c0)];
        s1[i] = slot[OFF_B + i * NU + (c + 1 - c0)];
      }
    }  // columns past block t stay zero
    if (c < n) {
      float* dst = S_out + st * NX * n + c;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(i) * n) = make_float2(s[i], s1[i]);
    } else if (c == n) {
#pragma unroll
      for (int i = 0; i < NX; ++i) phi_out[st * NX + i] = s[i];
    }
  }
}

}  // namespace

extern "C" int condense_f32(const void* A, const void* Bm, const void* d,
                            void* S_out, void* phi_out, int B, int Nt,
                            void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  const int pairs = Nt * NU / 2 + 1;  // S's column pairs and phi
  const int threads = pairs >= MAX_THREADS ? MAX_THREADS : (pairs + WARP - 1) / WARP * WARP;
  const int chunks = (pairs + threads - 1) / threads;
  const long long blocks = static_cast<long long>(B) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  condense_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(d), static_cast<float*>(S_out),
      static_cast<float*>(phi_out), Nt, chunks);
  return static_cast<int>(cudaGetLastError());
}
