// Riccati re-solve sweeps of the stagewise (long-horizon) MPC QP.
//
// Replaces ft_mpc_tpu/solvers/lanes_riccati.py:_bwd_kernel and _fwd_kernel
// (wrapper lqr_resolve_lanes).  Against a fixed LQR factorization
// (F, B, K, Quu_inv, PC, c; n = 13 states, m = 6 inputs), per scenario b:
//
//   backward, t = Nt-1 .. 0, carry p seeded with qN:
//       w   = PC_t + p
//       k_t = Quu_inv_t (r_t + B_t' w)            -> ks[b, t]
//       p   = q_t + F_t' w - K_t' r_t
//   forward, t = 0 .. Nt-1, carry x seeded with x0 (X[b, 0] = x0):
//       u_t     = -K_t x - k_t                    -> U[b, t]
//       x       = F_t x + c_t - B_t k_t           -> X[b, t+1]
//
// All float32, batch-leading (B, Nt, ...) storage, row-major blocks.
//
// Only the 13-vector carries are sequential, and the factorization is fixed
// for a whole ADMM phase, so riccati_prepare_f32 (one launch a phase)
// repacks each stage into one 16-byte-aligned record (with F'PC, B'PC and
// the transposes the backward products read as rows) and multiplies each
// chunk's transfer matrix Psi_c = F_{t1-1} ... F_{t0} (the horizon cut into
// C chunks of L stages).  riccati_split_f32 runs a re-solve (both sweeps,
// one launch) or one of its sweeps, one block a scenario, one warp a chunk:
//   1. each warp runs the backward recursion over its chunk from a zero
//      carry (pass 1);
//   2. one warp walks the C chunk boundaries: p_{t0} = Psi_c' p_{t1} + d_c;
//   3. each warp reruns its chunk from its true carry and writes ks (pass 2);
//   then the same for the forward sweep with x_{t1} = Psi_c x_{t0} + e_c,
//   where pass 2 writes X and U.  The dependent chain is 2 (2L + C) stage
//   steps instead of 2 Nt, and B x C warps share the card.  With C = 1 the
//   passes 1 and the walks drop out: a fused sequential re-solve, which
//   reads ks from shared memory instead of device memory.  Each stage's
//   record range a pass reads arrives in the warp's ring by one bulk copy
//   (the TMA unit, an mbarrier a slot), the next pass's first copies started
//   before the block waits at the walk.  Where the block's shared memory
//   holds the horizon's q, r and ks (Nt up to about 2200 at one chunk),
//   they are staged there, q and r (or ks) by one bulk copy each; beyond,
//   the passes read them from device memory.  Every lane's product reads one
//   contiguous row of 13 floats, so the stage step has no divergent branch
//   around its loads.  The plan (riccati_plan) takes 16 chunks up to B=320
//   and one beyond, fewer where that lets the block stage the linear terms.
//
// Bound on the H100: device-memory bytes (the factorization read once and
// ks, X, U written once, against ~700 flops a scenario-stage).  What sets
// the time is the dependent chain and, at small B, how many SMs it keeps
// busy.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NX = 13;
constexpr int NU = 6;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

namespace split {

// A stage's record (floats), 16-byte-aligned sections in an order that
// lets each pass copy one contiguous range holding what it reads.  Every
// lane's product reads one contiguous row of 13: in the backward passes a
// row of F' or B' (lane j < 13 the state entry j: F's column j; lane
// 13 + k the input entry k: B's column k), in the forward passes a row of K
// or F (lane k < 6 the input entry k; lane 6 + j the state entry j).
constexpr int QI = 0;     // Quu_inv, 6 x 6 row-major
constexpr int BPC = 36;   // B' PC (6)
constexpr int FPC = 44;   // F' PC (13)
constexpr int FT = 60;    // F', 13 x 13 row-major
constexpr int KM = 232;   // K, 6 x 13 row-major
constexpr int BT = 320;   // B', 6 x 13 row-major
constexpr int FM = 400;   // F, 13 x 13 row-major
constexpr int CV = 572;   // c (13)
constexpr int REC = 588;
// The two row groups a product reads at once (F' and B' rows backward, K
// and F rows forward) start (BT - FT) % 32 = 4 and (FM - KM) % 32 = 8
// banks apart: no state lane shares a bank with an input lane (13 (j - k)
// never meets those offsets mod 32 for the lanes' j and k).
// the passes' ranges: backward 1 [FPC, BT), backward 2 [QI, FM), forward
// 1 [BT, REC), forward 2 [KM, REC)
constexpr int PSI = 172;  // a chunk's transfer matrix in shared memory (169 used)
constexpr int VEC = 16;   // a padded 13-vector
constexpr int RING = 4;   // ring slots a warp
constexpr int MAX_CHUNKS = 16;  // 512 threads: up to 128 registers a thread
constexpr int PREP_THREADS = 128;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// shared memory of a re-solve block, floats (an mbarrier: 2); when staged,
// the horizon's q, r and ks follow, each 16-byte aligned
__host__ __device__ constexpr size_t floats(int Nt, int C, bool staged) {
  return static_cast<size_t>(C) * (RING * REC + PSI + 4 * VEC + 2 * RING) + 4 +
         (staged ? round4(Nt * NX) + 2 * round4(Nt * NU) : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier expecting `count` arrivals (each with its copy's bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy (the TMA unit) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// init + sum_i m[i S] v[i] over i < 13, v a padded vector read as four
// broadcast float4; four partial sums.  The m loads do not depend on v, so
// they go out ahead of the carry.
template <int S>
__device__ __forceinline__ float dot13(const float* m, const float* v, float init) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  const float4 b = *reinterpret_cast<const float4*>(v + 4);
  const float4 c = *reinterpret_cast<const float4*>(v + 8);
  const float d = v[12];
  float s0 = m[0] * a.x, s1 = m[S] * a.y, s2 = m[2 * S] * a.z, s3 = m[3 * S] * a.w;
  s0 += m[4 * S] * b.x;
  s1 += m[5 * S] * b.y;
  s2 += m[6 * S] * b.z;
  s3 += m[7 * S] * b.w;
  s0 += m[8 * S] * c.x;
  s1 += m[9 * S] * c.y;
  s2 += m[10 * S] * c.z;
  s3 += m[11 * S] * c.w;
  s0 += m[12 * S] * d;
  return init + ((s0 + s1) + (s2 + s3));
}

// sum_a m[13 a] w[a] over a < 6, w 8-byte aligned (a broadcast row of 6)
__device__ __forceinline__ float dot6(const float* m, const float* w) {
  const float2 a = *reinterpret_cast<const float2*>(w);
  const float2 b = *reinterpret_cast<const float2*>(w + 2);
  const float2 c = *reinterpret_cast<const float2*>(w + 4);
  return (m[0] * a.x + m[NX] * a.y) + (m[2 * NX] * b.x + m[3 * NX] * b.y) +
         (m[4 * NX] * c.x + m[5 * NX] * c.y);
}

// A warp's ring: RING slots of one record each, one mbarrier a slot, and g,
// the steps it has served (which fixes each slot's barrier phase).  A pass
// over the chunk [t0, t1) (backward when REV) copies the record range
// [LO, HI) of each stage by one bulk copy (lane 0), RING stages ahead:
// `prologue` starts its first RING copies (as soon as the ring is free),
// `run` calls body(t, slot, s) on stage t (step s).
struct Ring {
  float* slots;
  uint64_t* bars;
  const float* rec;
  uint32_t g;
  int lane;

  template <int LO, int HI>
  __device__ __forceinline__ void load(int t, uint32_t gs) {
    static_assert(LO % 4 == 0 && HI % 4 == 0, "16-byte copies");
    const uint32_t k = gs % RING;
    bulk_load(slots + k * REC + LO, rec + static_cast<size_t>(t) * REC + LO,
              (HI - LO) * sizeof(float), bars + k);
  }

  template <int LO, int HI, bool REV>
  __device__ __forceinline__ void prologue(int t0, int t1) {
    if (lane == 0)
      for (int s = 0; s < RING && s < t1 - t0; ++s) load<LO, HI>(REV ? t1 - 1 - s : t0 + s, g + s);
  }

  template <int LO, int HI, bool REV, typename Body>
  __device__ __forceinline__ void run(int t0, int t1, Body&& body) {
    const int n = t1 - t0;
    __syncwarp(FULL);  // the carry buffer's first entries
    for (int s = 0; s < n; ++s) {
      const uint32_t gs = g + s;
      const uint32_t k = gs % RING;
      mbar_wait(bars + k, (gs / RING) & 1);
      body(REV ? t1 - 1 - s : t0 + s, slots + k * REC, s);
      __syncwarp(FULL);  // the slot and the carry buffer are free again
      if (lane == 0 && s + RING < n)
        load<LO, HI>(REV ? t1 - 1 - s - RING : t0 + s + RING, gs + RING);
    }
    g += n;
  }
};

// One block a scenario, one warp a chunk of L stages (blockDim.x = 32 C;
// CHUNKED: C > 1, one instance each so that the one-chunk kernel carries no
// code of the passes 1 and walks).  parts: 1 the backward sweep (q, r, qN ->
// ks), 2 the forward sweep (ks, x0 -> X, U), 3 both; ks is written when
// given (parts & 1) and read when parts == 2.  STAGED: q, r and ks of the
// whole horizon sit in shared memory, else the passes read them (and parts
// 3 its ks, which it then needs) in device memory.  bulk (STAGED only): q,
// r and ks rows are 16-byte aligned (one bulk copy each), else they are
// loaded by every thread.
template <bool CHUNKED, bool STAGED>
__global__ void __launch_bounds__(MAX_CHUNKS * WARP) riccati_split_kernel(
    const float* __restrict__ rec,  // (B, Nt, REC) from riccati_prepare_f32
    const float* __restrict__ psi,  // (B, C, 13, 13), unused when C == 1
    const float* __restrict__ q,    // (B, Nt, 13)
    const float* __restrict__ r,    // (B, Nt, 6)
    const float* __restrict__ qN,   // (B, 13)
    const float* __restrict__ x0,   // (B, 13)
    float* __restrict__ ks,         // (B, Nt, 6) or null
    float* __restrict__ X,          // (B, Nt + 1, 13)
    float* __restrict__ U,          // (B, Nt, 6)
    int Nt, int L, int parts, int bulk) {
  extern __shared__ __align__(16) float smem[];
  const int C = blockDim.x / WARP;
  const int w = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int b = blockIdx.x;
  const int t0 = w * L;
  const int t1 = min(t0 + L, Nt);
  const size_t nb = static_cast<size_t>(b) * Nt;

  float* psi_sh = smem + C * RING * REC;  // C x PSI
  float* vb = psi_sh + C * PSI;           // C x 2 VEC: each warp's carry, double-buffered
  float* dv = vb + C * 2 * VEC;           // C x VEC: pass 1's chunk results
  float* cv = dv + C * VEC;               // C x VEC: the true carries at the chunk ends
  uint64_t* bars = reinterpret_cast<uint64_t*>(cv + C * VEC);  // C x RING, then 1
  uint64_t* lin_bar = bars + C * RING;    // the linear terms' bulk copies
  float* q_sh = reinterpret_cast<float*>(lin_bar + 2);  // STAGED: Nt x 13
  float* r_sh = q_sh + round4(Nt * NX);                 // Nt x 6
  float* ks_sh = r_sh + round4(Nt * NU);                // Nt x 6
  // the scenario's linear terms, as the passes read them
  const float* qs = STAGED ? q_sh : q + nb * NX;
  const float* rs = STAGED ? r_sh : r + nb * NU;
  float* kss = STAGED ? ks_sh : ks + nb * NU;
  float* vbw = vb + w * 2 * VEC;
  Ring ring{smem + w * RING * REC, bars + w * RING, rec + nb * REC, 0, lane};

  // lanes of the backward passes: 0..12 a state entry, 13..18 an input
  // entry; of the forward passes: 0..5 an input entry, 6..18 a state entry.
  // The other lanes compute on the last lane's addresses and store nothing.
  const int bj = min(lane, NX - 1), bk = min(max(lane - NX, 0), NU - 1);
  const int fk = min(lane, NU - 1), fj = min(max(lane - NU, 0), NX - 1);
  const bool bx = lane < NX, bu = lane >= NX && lane < NX + NU;
  const bool fu = lane < NU, fx = lane >= NU && lane < NX + NU;
  const int brow = bx ? FT + NX * bj : BT + NX * bk;  // its row of F' or B'
  const int frow = fu ? KM + NX * fk : FM + NX * fj;  // its row of K or F

  if (lane == 0) {
    for (int k = 0; k < RING; ++k) mbar_init(ring.bars + k, 1);
    if (w == 0) mbar_init(lin_bar, (parts & 1) ? 2 : 1);
    mbar_fence_init();
  }
  if (STAGED && bulk && threadIdx.x == 0) {
    if (parts & 1) {
      bulk_load(q_sh, q + nb * NX, Nt * NX * sizeof(float), lin_bar);
      bulk_load(r_sh, r + nb * NU, Nt * NU * sizeof(float), lin_bar);
    } else {
      bulk_load(ks_sh, ks + nb * NU, Nt * NU * sizeof(float), lin_bar);
    }
  }
  if (parts & 1) {
    if constexpr (CHUNKED) ring.prologue<FPC, BT, true>(t0, t1);
    else ring.prologue<QI, FM, true>(t0, t1);
  } else if constexpr (CHUNKED) {
    ring.prologue<BT, REC, false>(t0, t1);
  } else {
    ring.prologue<KM, REC, false>(t0, t1);
  }
  if (STAGED && !bulk) {
    if (parts & 1) {
      for (int i = threadIdx.x; i < Nt * NX; i += blockDim.x) q_sh[i] = q[nb * NX + i];
      for (int i = threadIdx.x; i < Nt * NU; i += blockDim.x) r_sh[i] = r[nb * NU + i];
    } else {
      for (int i = threadIdx.x; i < Nt * NU; i += blockDim.x) ks_sh[i] = ks[nb * NU + i];
    }
  }
  if constexpr (CHUNKED) {
    const float* pb = psi + static_cast<size_t>(b) * C * NX * NX;
    for (int i = threadIdx.x; i < C * NX * NX; i += blockDim.x)
      psi_sh[(i / (NX * NX)) * PSI + i % (NX * NX)] = pb[i];
  }
  __syncthreads();
  if (STAGED && bulk) mbar_wait(lin_bar, 0);

  // a_t = q_t + F_t' PC_t - K_t' r_t, the backward recursion's carry-free term
  const float* qs_j = qs + bj;
  auto a_of = [&](int t, const float* slot) {
    return (qs_j[t * NX] + slot[FPC + bj]) - dot6(slot + KM + bj, rs + t * NU);
  };
  // g_t = c_t - B_t k_t, the forward recursion's carry-free term
  auto g_of = [&](int t, const float* slot) {
    return slot[CV + fj] - dot6(slot + BT + fj, kss + t * NU);
  };

  if (parts & 1) {
    if constexpr (CHUNKED) {  // pass 1: d_w, the carry at t0 from a zero carry at t1
      if (lane < VEC) vbw[lane] = 0.f;
      float p = 0.f;
      ring.run<FPC, BT, true>(t0, t1, [&](int t, const float* slot, int s) {
        p = dot13<1>(slot + brow, vbw + (s & 1) * VEC, a_of(t, slot));
        if (bx) vbw[((s + 1) & 1) * VEC + lane] = p;
      });
      if (bx) dv[w * VEC + lane] = p;
      ring.prologue<QI, FM, true>(t0, t1);
      __syncthreads();
      if (w == 0) {  // the walk over the chunk ends, last chunk first
        p = bx ? qN[static_cast<size_t>(b) * NX + lane] : 0.f;
        if (bx) cv[(C - 1) * VEC + lane] = p;
        for (int ci = C - 1; ci >= 1; --ci) {
          if (bx) vbw[lane] = p;
          __syncwarp(FULL);
          p = dot13<NX>(psi_sh + ci * PSI + bj, vbw, dv[ci * VEC + bj]);  // Psi' p + d
          __syncwarp(FULL);
          if (bx) cv[(ci - 1) * VEC + lane] = p;
        }
      }
      __syncthreads();
    }
    {  // pass 2 from the true carry: ks
      float p = bx ? (CHUNKED ? cv[w * VEC + lane] : qN[static_cast<size_t>(b) * NX + lane])
                   : 0.f;
      if (lane < VEC) vbw[lane] = p;
      ring.run<QI, FM, true>(t0, t1, [&](int t, const float* slot, int s) {
        // lanes 0..12: p_t = a_t + F_t' p; lanes 13..18: v = r_t + B_t' PC_t + B_t' p
        const float a = a_of(t, slot), v0 = rs[t * NU + bk] + slot[BPC + bk];
        const float acc = dot13<1>(slot + brow, vbw + (s & 1) * VEC, bx ? a : v0);
        float kv = 0.f;  // k_t = Quu_inv_t v, v from lanes 13..18
#pragma unroll
        for (int c = 0; c < NU; ++c)
          kv += slot[QI + bk * NU + c] * __shfl_sync(FULL, acc, NX + c);
        if (bu) {
          if (STAGED) kss[t * NU + bk] = kv;
          if (ks != nullptr) ks[(nb + t) * NU + bk] = kv;  // unstaged: kss's own row
        }
        if (bx) vbw[((s + 1) & 1) * VEC + lane] = acc;
      });
    }
  }

  if (parts & 2) {
    if (parts & 1) {
      if constexpr (CHUNKED) ring.prologue<BT, REC, false>(t0, t1);
      else ring.prologue<KM, REC, false>(t0, t1);
    }
    if constexpr (CHUNKED) {  // pass 1: e_w, the state at t1 from a zero state at t0
      if (lane < VEC) vbw[lane] = 0.f;
      float x = 0.f;
      ring.run<BT, REC, false>(t0, t1, [&](int t, const float* slot, int s) {
        const float g = g_of(t, slot);
        x = dot13<1>(slot + frow, vbw + (s & 1) * VEC, fx ? g : 0.f);
        if (fx) vbw[((s + 1) & 1) * VEC + fj] = x;
      });
      if (fx) dv[w * VEC + fj] = x;
      ring.prologue<KM, REC, false>(t0, t1);
      __syncthreads();
      if (w == 0) {  // the walk over the chunk starts, first chunk first
        x = bx ? x0[static_cast<size_t>(b) * NX + lane] : 0.f;
        if (bx) cv[lane] = x;
        for (int ci = 0; ci + 1 < C; ++ci) {
          if (bx) vbw[lane] = x;
          __syncwarp(FULL);
          x = dot13<1>(psi_sh + ci * PSI + NX * bj, vbw, dv[ci * VEC + bj]);  // Psi x + e
          __syncwarp(FULL);
          if (bx) cv[(ci + 1) * VEC + lane] = x;
        }
      }
      __syncthreads();
    }
    {  // pass 2 from the true state: X, U
      float x = fx ? (CHUNKED ? cv[w * VEC + fj] : x0[static_cast<size_t>(b) * NX + fj]) : 0.f;
      if (fx) vbw[fj] = x;
      float* Xb = X + static_cast<size_t>(b) * (Nt + 1) * NX;
      ring.run<KM, REC, false>(t0, t1, [&](int t, const float* slot, int s) {
        // lanes 6..18: x_{t+1} = F_t x + g_t; lanes 0..5: K_t x
        const float g = g_of(t, slot);
        const float acc = dot13<1>(slot + frow, vbw + (s & 1) * VEC, fx ? g : 0.f);
        if (fx) {
          Xb[t * NX + fj] = x;
          x = acc;
          vbw[((s + 1) & 1) * VEC + fj] = acc;
        }
        if (fu) U[(nb + t) * NU + fk] = -acc - kss[t * NU + fk];
      });
      if (fx && t1 == Nt) Xb[Nt * NX + fj] = x;
    }
  }
}

// Repack each stage into its record and, with C > 1, multiply each chunk's
// Psi = F_{t1-1} ... F_{t0}.  One block of PREP_THREADS a (scenario, chunk).
__global__ void __launch_bounds__(PREP_THREADS) riccati_prepare_kernel(
    const float* __restrict__ F,    // (B, Nt, 13, 13)
    const float* __restrict__ Bm,   // (B, Nt, 13, 6)
    const float* __restrict__ K,    // (B, Nt, 6, 13)
    const float* __restrict__ Qi,   // (B, Nt, 6, 6)
    const float* __restrict__ PC,   // (B, Nt, 13)
    const float* __restrict__ c,    // (B, Nt, 13)
    float* __restrict__ rec,        // (B, Nt, REC)
    float* __restrict__ psi,        // (B, C, 13, 13) or null
    int Nt, int L) {
  __shared__ float P[2][NX * NX];
  __shared__ float Fs[NX * NX];
  const int b = blockIdx.x;
  const int ci = blockIdx.y;
  const int C = gridDim.y;
  const int t0 = ci * L;
  const int t1 = min(t0 + L, Nt);
  const int tid = threadIdx.x;

  for (int idx = tid; idx < (t1 - t0) * REC; idx += PREP_THREADS) {
    const size_t st = static_cast<size_t>(b) * Nt + t0 + idx / REC;
    const int o = idx % REC;
    float v = 0.f;
    if (o < BPC) {
      v = Qi[st * NU * NU + o];
    } else if (o < FPC) {
      const int e = o - BPC;
      if (e < NU)
        for (int i = 0; i < NX; ++i) v += Bm[(st * NX + i) * NU + e] * PC[st * NX + i];
    } else if (o < FT) {
      const int e = o - FPC;
      if (e < NX)
        for (int i = 0; i < NX; ++i) v += F[(st * NX + i) * NX + e] * PC[st * NX + i];
    } else if (o < KM) {
      const int e = o - FT;  // F' row e / 13 = F's column
      if (e < NX * NX) v = F[(st * NX + e % NX) * NX + e / NX];
    } else if (o < BT) {
      const int e = o - KM;
      if (e < NU * NX) v = K[st * NU * NX + e];
    } else if (o < FM) {
      const int e = o - BT;  // B' row e / 13 = B's column
      if (e < NU * NX) v = Bm[(st * NX + e % NX) * NU + e / NX];
    } else if (o < CV) {
      const int e = o - FM;
      if (e < NX * NX) v = F[st * NX * NX + e];
    } else {
      const int e = o - CV;
      if (e < NX) v = c[st * NX + e];
    }
    rec[st * REC + o] = v;
  }
  if (psi == nullptr) return;  // the same for every block of the launch

  const float* Fb = F + static_cast<size_t>(b) * Nt * NX * NX;
  for (int e = tid; e < NX * NX; e += PREP_THREADS) P[0][e] = Fb[t0 * NX * NX + e];
  int cur = 0;
  for (int t = t0 + 1; t < t1; ++t) {
    for (int e = tid; e < NX * NX; e += PREP_THREADS) Fs[e] = Fb[t * NX * NX + e];
    __syncthreads();
    for (int e = tid; e < NX * NX; e += PREP_THREADS) {
      const int row = e / NX, col = e % NX;
      float s = 0.f;
      for (int i = 0; i < NX; ++i) s += Fs[row * NX + i] * P[cur][i * NX + col];
      P[cur ^ 1][e] = s;
    }
    __syncthreads();
    cur ^= 1;
  }
  float* out = psi + (static_cast<size_t>(b) * C + ci) * NX * NX;
  for (int e = tid; e < NX * NX; e += PREP_THREADS) out[e] = P[cur][e];
}

using SplitKernel = void (*)(const float*, const float*, const float*, const float*,
                            const float*, const float*, float*, float*, float*, int, int, int,
                            int);

SplitKernel kernel_for(int C, bool staged) {
  if (C > 1) return staged ? riccati_split_kernel<true, true> : riccati_split_kernel<true, false>;
  return staged ? riccati_split_kernel<false, true> : riccati_split_kernel<false, false>;
}

constexpr size_t SMEM_CAP = 227 * 1024;
// Chunks pay while the card has room for their warps: up to this batch a
// scenario's horizon is cut into min(MAX_CHUNKS, sqrt(2 Nt)) chunks (the
// chain 2 L + C is shortest near C = sqrt(2 Nt)), beyond it into one
// (kernel_ab.py's chunk sweep at Nt=240 on an H100: 16 chunks fastest up to
// B=256, one chunk from B=384).
constexpr int CHUNKED_MAX_B = 320;

// Whether a re-solve block of C chunks stages the horizon's linear terms.
bool staged_of(int Nt, int C) { return floats(Nt, C, true) * sizeof(float) <= SMEM_CAP; }

// The plan at (B, Nt > 0): *L stages a chunk, *C chunks.  The most chunks
// up to the wanted count whose block stages the linear terms, else (long
// horizons) the wanted count, unstaged.
void plan_of(int B, int Nt, int* L, int* C) {
  int root = 1;
  while ((root + 1) * (root + 1) <= 2 * Nt) ++root;
  const int want = B <= CHUNKED_MAX_B ? std::min(MAX_CHUNKS, root) : 1;
  for (int c = want; c >= 1; --c) {
    *L = (Nt + c - 1) / c;
    *C = (Nt + *L - 1) / *L;
    if (staged_of(Nt, *C)) return;
  }
  *L = (Nt + want - 1) / want;
  *C = (Nt + *L - 1) / *L;
}

}  // namespace split

}  // namespace

// The re-solve's plan at (B, Nt).  out[0..6]: stages a chunk L, chunks C,
// threads a block, dynamic shared memory a block (bytes), blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), whether the block stages
// the linear terms, its cudaError_t.
extern "C" int riccati_plan(int B, int Nt, int* out) {
  for (int i = 0; i < 7; ++i) out[i] = 0;
  if (B <= 0 || Nt <= 0) return 0;
  int L = 0, C = 0;
  split::plan_of(B, Nt, &L, &C);
  const bool staged = split::staged_of(Nt, C);
  const size_t smem = split::floats(Nt, C, staged) * sizeof(float);
  out[0] = L;
  out[1] = C;
  out[2] = C * WARP;
  out[3] = static_cast<int>(smem);
  out[5] = staged;
  const auto kernel = split::kernel_for(C, staged);
  cudaError_t err = ftmpc_allow_smem(kernel, split::SMEM_CAP);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel, C * WARP, smem);
  out[6] = static_cast<int>(err);
  return 0;
}

// Whether the re-solve at chunk length L stages the linear terms (1), or
// reads them in device memory (0), when a launch with parts 3 needs ks.
extern "C" int riccati_staged(int Nt, int L) {
  if (Nt <= 0 || L < 1) return 1;
  return split::staged_of(Nt, (Nt + L - 1) / L);
}

// Once a phase: the records and transfer matrices the re-solves read.
// rec (B, Nt, REC = 588) floats; psi (B, C, 13, 13), C = ceil(Nt / L), written
// only when C > 1.
extern "C" int riccati_prepare_f32(const void* F, const void* Bm, const void* K,
                                   const void* Qi, const void* PC, const void* c,
                                   void* rec, void* psi, int B, int Nt, int L,
                                   void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int C = (Nt + L - 1) / L;
  if (C > split::MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  split::riccati_prepare_kernel<<<dim3(B, C), split::PREP_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      f(F), f(Bm), f(K), f(Qi), f(PC), f(c), static_cast<float*>(rec),
      C > 1 ? static_cast<float*>(psi) : nullptr, Nt, L);
  return static_cast<int>(cudaGetLastError());
}

// One re-solve (parts 3: both sweeps, one launch), or one of its sweeps
// (parts 1: backward, writes ks; parts 2: forward, reads ks).  ks may be
// null when parts == 3 and riccati_staged(Nt, L).
extern "C" int riccati_split_f32(const void* rec, const void* psi, const void* q,
                                 const void* r, const void* qN, const void* x0, void* ks,
                                 void* X, void* U, int B, int Nt, int L, int parts,
                                 void* stream) {
  if (B <= 0 || Nt <= 0) return 0;
  if (L < 1 || parts < 1 || parts > 3 || (parts == 2 && ks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = (Nt + L - 1) / L;
  const bool staged = split::staged_of(Nt, C);
  const size_t smem = split::floats(Nt, C, staged) * sizeof(float);
  if (C > split::MAX_CHUNKS || smem > split::SMEM_CAP || (!staged && ks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = split::kernel_for(C, staged);
  cudaError_t err = ftmpc_allow_smem(kernel, split::SMEM_CAP);
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, r and ks rows by bulk copies where every row starts 16-byte aligned
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int bulk =
      staged && Nt % 4 == 0 && ((parts & 1) ? aligned(q) && aligned(r) : aligned(ks));
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  kernel<<<B, C * WARP, smem, static_cast<cudaStream_t>(stream)>>>(
      f(rec), f(psi), f(q), f(r), f(qN), f(x0), static_cast<float*>(ks),
      static_cast<float*>(X), static_cast<float*>(U), Nt, L, parts, bulk);
  return static_cast<int>(cudaGetLastError());
}
