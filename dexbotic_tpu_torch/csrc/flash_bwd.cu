// K3: masked grouped-query flash-attention backward for Hopper (sm_90a).
//
// Replaces the four TPU backward kernels of dexbotic_tpu/ops/attention.py:
// _flash_bwd_single_kernel (whole sequence), _flash_bwd_fused_kernel (one
// pass writing per-kv-block dq partials) and the split pair
// _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel, and the preprocessing of
// _flash_bwd_impl.  Their split followed VMEM sizes and the TPU's sequential
// grid; here one design serves every length.
//
// What it computes: the FlashAttention-2 backward of K1 (flash_fwd.cu) from
// the log-sum-exp K1 saved, with the mask rebuilt from the same int vectors
// (query i sees key j iff kv_grp[j] <= q_grp[i] && kv_valid[j] &&
// q_seg[i] == kv_seg[j]):
//   q~  = bf16(float(q) * scale)     delta = rowsum(float(dO) * float(O))
//   P   = exp(S - lse) where allowed, else 0,   S = q~ k^T
//   dV += P^T dO        dP = dO V^T        dS = P * (dP - delta)
//   dK += dS^T q~       dQ = scale * dS K
// dK and dV are summed over the query heads of a GQA group in fp32
// registers.  Rows that see no key get P = 0 (their lse is ~MASKED_BIAS, so
// exp is only taken under the mask's select, never multiplied by it).
//
// What bounds it on the card: about 10*S^2*D flops per (b, h) over 10*S*D
// bytes, so the tensor cores, at full rate only through wgmma.
// Design (FlashAttention-3's backward shape, dQ by a second launch):
//  * pre_kernel: one pass over q, O and dO writing q~ and delta (dO read
//    through its own strides);
//  * the class map of K1's tile_class_kernel (dead / partial / visible per
//    64 x 64 tile pair): dead pairs are skipped, visible ones skip the mask
//    test;
//  * dkv_kernel, one block per (kv tile, kv head, b), the kv tiles that
//    most q tiles reach (the first, under a causal mask) first.  K and V of
//    the tile arrive once by TMA; one producer warp streams (query head of
//    the group, 64-row q tile) items, q~ and dO by TMA plus lse, delta and
//    the q mask vectors, through a ring of stages under mbarriers.  Consumer
//    warpgroups of 64 kv rows compute S^T = K q~^T and dP^T = V dO^T by
//    wgmma from shared memory, P^T (while dP^T runs) and dS^T in registers,
//    then dV += P^T dO (while dS^T is formed) and dK += dS^T q~ by wgmma
//    with A from those registers and dO, q~ as transposed B operands;
//  * dq_kernel, one block per (q tile, q head, b), heaviest first, the same
//    producer: q~ and dO stay in shared memory, K and V tiles of 64 rows
//    stream in, and consumer warpgroups of 64 q rows recompute S and dP to
//    accumulate dQ += dS K.
// Head dims 64 and 128: 128-row kv and q tiles, two consumer warpgroups
// (each holding its dK and dV, 64 + 64 fp32 a thread at 128) and a producer
// warpgroup that gives its registers away by setmaxnreg, rings of three
// stages.
// Head dim 256 (pi0's Gemma): dK and dV of 64 kv rows are 128 fp32 a thread
// each, so no warpgroup holds both, and a 64-row q~/dO stage is 64 KB, so
// two stages and a 64-row K/V tile (192 KB) are what shared memory holds.
// dkv256_kernel gives a 64-row kv tile's dV and dK to the two consumer
// warpgroups of one block: the first computes S^T, P^T and dV, and hands P^T
// in fp32 to the second through 16 KB of shared memory; the second computes
// dP^T, dS^T and dK (hi + lo), so S^T is computed once and neither warpgroup
// holds both accumulators (dK's holds no P^T either: it reads it from shared
// memory as it forms dS^T).  Each warpgroup queues its next item's first
// product (S^T, dP^T) behind its last (dV, dK), and the two run the exp and
// the dS^T of one item under each other's products.  A kv tile's work list
// (query head of the group x live q tile) is cut into `splits` contiguous
// shares, one block each, so that small batches fill the card
// (ops/attention.py:bwd_splits picks the count); the blocks write fp32
// partial dK and dV and dkv_sum_kernel adds them up in share order, or, at
// one share, the block writes bf16 itself.  dq256_kernel takes a 64-row q
// tile a block (128-row tiles on two warpgroups spill under setmaxnreg's
// 240 registers; PERF.md) and splits it the same way: its first warpgroup
// computes S, P, dP and dS, queueing the next kv tile's S and dP while the
// second takes the dS it hands over in fp32 and accumulates dQ (hi + lo).
// Every launch is deterministic: every output element is summed by one
// thread in a fixed order, no atomics.
// Precision: P and dS may enter their products (dV, dK, dQ) as two bf16
// parts each, hi = bf16(x) and lo = bf16(x - hi), one wgmma per part, so
// they keep ~16 bits as the JAX kernels' fp32 P and dS do.  K3_LO_PARTS
// picks the products that take the lo part (bit 0 dV, 1 dK, 2 dQ).  dK and
// dQ keep it (each row of dS sums to zero, so both products cancel): over
// 100 seeded draws at the training shape P rounded once left dV within 0.82
// of chip_smoke's error bound, dS rounded once took dK to 1.13, and dQ broke
// the bound of a smaller unit-test shape (script/bench_flash_torch.py sweep;
// PERF.md).

#include <type_traits>

#include "hopper.cuh"

#ifndef K3_LO_PARTS
#define K3_LO_PARTS 6
#endif

using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr bool LO_DV = K3_LO_PARTS & 1, LO_DK = K3_LO_PARTS & 2, LO_DQ = K3_LO_PARTS & 4;
constexpr int MAX_TILES = 256;  // 64-row tiles: Sq, Skv <= 16384
enum : int { ACC_DV = 1, ACC_DK = 2, ACC_BOTH = 3 };  // what a dkv consumer accumulates

// threads of a block with NWG consumer warpgroups: one producer warp, or at
// NWG = 2 a producer warpgroup (setmaxnreg needs whole warpgroups).
// Arithmetic, not ?:, which nvcc's host stub rejects in __launch_bounds__.
#define K3_THREADS(NWG) (128 * (NWG) + 32 + 96 * ((NWG) - 1))

// ---------------------------------------------------------------------------
// q~ and delta: one warp per (b, i, h) row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) pre_kernel(const bf16* __restrict__ q,
                                                  const bf16* __restrict__ out,
                                                  const bf16* __restrict__ dout, long long do_sb,
                                                  long long do_ss, long long do_sh,
                                                  bf16* __restrict__ qs, float* __restrict__ delta,
                                                  int B, int Sq, int Hq, float scale) {
  constexpr int E = D / 32;  // elements a lane: 8 (16 bytes), 4 (8 bytes) or 2 (4 bytes)
  using V = typename std::conditional<
      E == 8, uint4, typename std::conditional<E == 4, uint2, uint32_t>::type>::type;
  const size_t row = size_t(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= size_t(B) * Sq * Hq) return;
  const int h = row % Hq, i = (row / Hq) % Sq, b = row / (size_t(Hq) * Sq);
  const V qv = *reinterpret_cast<const V*>(q + row * D + lane * E);
  const V ov = *reinterpret_cast<const V*>(out + row * D + lane * E);
  const V dv = *reinterpret_cast<const V*>(dout + b * do_sb + i * do_ss + h * do_sh + lane * E);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  V sv;
  uint32_t* s32 = reinterpret_cast<uint32_t*>(&sv);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    s32[e] = pack_bf16(__low2float(q2[e]) * scale, __high2float(q2[e]) * scale);
    acc += __low2float(d2[e]) * __low2float(o2[e]) + __high2float(d2[e]) * __high2float(o2[e]);
  }
  *reinterpret_cast<V*>(qs + row * D + lane * E) = sv;
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(size_t(b) * Hq + h) * Sq + i] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV at head dims 64 and 128: one block per (KR-row kv tile, kv head, b)
// ---------------------------------------------------------------------------

template <int D, int KR, int ST>
struct DkvSmem {
  static constexpr int P = D / 64;
  alignas(1024) bf16 k[P][KR * 64];
  alignas(1024) bf16 v[P][KR * 64];
  alignas(1024) bf16 q[ST][P][64 * 64];
  alignas(1024) bf16 dO[ST][P][64 * 64];
  float lse[ST][64], delta[ST][64];
  int qg[ST][64], qs[ST][64];
  uint64_t full[ST], empty[ST], kvbar;
  short live[MAX_TILES];
  uint8_t cls[MAX_TILES];
  int nlive;
};

// The 64-row q tiles that reach kv tiles [ka, kb) of batch b, listed with
// their classes in sm.live / sm.cls (one warp), and their count.
template <class Smem>
__device__ __forceinline__ int list_live_q_tiles(Smem& sm, const uint8_t* __restrict__ cls, int b,
                                                 int Sq, int Skv, int ka, int kb) {
  const int lane = threadIdx.x % 32;
  const int nq64 = (Sq + TILE - 1) / TILE, nk64 = (Skv + TILE - 1) / TILE;
  const uint8_t* map = cls + size_t(b) * nq64 * nk64;
  int n = 0;
  for (int t0 = 0; t0 < nq64; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < nq64 ? tile_class(map, nq64, nk64, t, t + 1, ka, kb) : DEAD;
    const unsigned live = __ballot_sync(0xffffffffu, c != DEAD);
    if (c != DEAD) {
      const int pos = n + __popc(live & ((1u << lane) - 1));
      sm.live[pos] = static_cast<short>(t);
      sm.cls[pos] = static_cast<uint8_t>(c);
    }
    n += __popc(live);
  }
  return n;
}

// The producer warp's stream of items [i0, i1) of a kv tile's work list
// (item -> query head hk * group + item / nlive, q tile live[item % nlive]):
// q~ and dO by TMA, lse, delta and the q mask vectors by the warp, into a
// ring of ST stages.
template <int D, int ST, class Smem>
__device__ __forceinline__ void produce_q_items(Smem& sm, const CUtensorMap* tq,
                                                const CUtensorMap* tdo, const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                const int* __restrict__ q_grp,
                                                const int* __restrict__ q_seg, int i0, int i1,
                                                int nlive, int group, int hk, int b, int Sq, int Hq) {
  constexpr int P = D / 64;
  const int lane = threadIdx.x % 32;
  const int* qgb = q_grp + size_t(b) * Sq;
  const int* qsb = q_seg ? q_seg + size_t(b) * Sq : nullptr;
  for (int it = 0; it < i1 - i0; ++it) {
    const int s = it % ST, h = hk * group + (i0 + it) / nlive, r0 = sm.live[(i0 + it) % nlive] * 64;
    mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[s], 2 * 64 * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tma_load(sm.q[s][p], tq, &sm.full[s], p * 64, h, r0, b);
        tma_load(sm.dO[s][p], tdo, &sm.full[s], p * 64, h, r0, b);
      }
    }
    for (int r = lane; r < 64; r += 32) {  // rows past Sq: P = exp(-inf) = 0
      const int i = r0 + r;
      const bool in = i < Sq;
      const size_t row = (size_t(b) * Hq + h) * Sq + i;
      sm.lse[s][r] = in ? lse[row] : INFINITY;
      sm.delta[s][r] = in ? delta[row] : 0.f;
      sm.qg[s][r] = in ? qgb[i] : INT_MIN;
      sm.qs[s][r] = in && qsb ? qsb[i] : 0;
    }
    mbar_arrive(&sm.full[s]);
  }
}

// One consumer warpgroup over the block's items: for its 64 kv rows (rows
// kr.. of the block's K/V tile, k0 + kr.. of the sequence), dV += P^T dO and
// dK += dS^T q~, then those rows of dK/dV written out.
template <int D, int KR, int ST>
__device__ __forceinline__ void dkv_consume(DkvSmem<D, KR, ST>& sm, int kr, int k0, int nlive,
                                            int nitems, const int* __restrict__ kv_grp,
                                            const int* __restrict__ kv_valid,
                                            const int* __restrict__ kv_seg, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int Skv, int Hkv, int hk, int b) {
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  int kg_r[2], kvv_r[2], ks_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + kr + w * 16 + g + 8 * r;
    const bool in = j < Skv;
    kvv_r[r] = in ? kv_valid[size_t(b) * Skv + j] : 0;
    kg_r[r] = in ? kv_grp[size_t(b) * Skv + j] : INT_MAX;
    ks_r[r] = in && kv_seg ? kv_seg[size_t(b) * Skv + j] : 0;
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = 0.f;
  mbar_wait(&sm.kvbar, 0);

  for (int it = 0; it < nitems; ++it) {
    const int s = it % ST;
    mbar_wait(&sm.full[s], (it / ST) & 1);

    // ---- S^T = K q~^T, then dP^T = V dO^T (64 kv rows x 64 q columns) ----
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<64>(st, desc_k(sm.k[p] + kr * 64 + off), desc_k(sm.q[s][p] + off), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<64>(dpt, desc_k(sm.v[p] + kr * 64 + off), desc_k(sm.dO[s][p] + off), kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T still runs
    fence_regs(st);

    // ---- P^T (fp32, masked before exp can overflow) ----
    const bool partial = sm.cls[it % nlive] == PARTIAL;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
        const bool ok = !partial || (kvv_r[r] && kg_r[r] <= sm.qg[s][c] && ks_r[r] == sm.qs[s][c]);
        st[4 * j + e] = ok ? __expf(st[4 * j + e] - sm.lse[s][c]) : 0.f;
      }

    // ---- dV += P^T dO (A from registers, dO the transposed B), while
    // dS^T = P^T (dP^T - delta) is formed; then dK += dS^T q~ ----
    uint32_t pa[4][4], da[4][4];
    [[maybe_unused]] uint32_t pl[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(pa[kk], st, kk);
      if constexpr (LO_DV) acc_rest_to_a(pl[kk], pa[kk], st, kk);
    }
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bo = desc_mn(sm.dO[s][0] + kk * 16 * 64, 64 * 64 * 2);
      wgmma_rs<D>(dv_acc, pa[kk], bo, 1);
      if constexpr (LO_DV) wgmma_rs<D>(dv_acc, pl[kk], bo, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV still runs
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - sm.delta[s][c]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(da[kk], dpt, kk);
      if constexpr (LO_DK) acc_rest_to_a(dl[kk], da[kk], dpt, kk);
    }
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bq = desc_mn(sm.q[s][0] + kk * 16 * 64, 64 * 64 * 2);
      wgmma_rs<D>(dk_acc, da[kk], bq, 1);
      if constexpr (LO_DK) wgmma_rs<D>(dk_acc, dl[kk], bq, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(pa);
    if constexpr (LO_DV) fence_regs(pl);
    fence_regs(dk_acc);
    fence_regs(da);
    if constexpr (LO_DK) fence_regs(dl);
    mbar_arrive(&sm.empty[s]);
  }

  // ---- dK (w.r.t. the scaled q~: the scale is folded in) and dV ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + kr + w * 16 + g + 8 * r;
    if (j >= Skv) continue;
    const size_t off = ((size_t(b) * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t4) =
          pack_bf16(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t4) =
          pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

// NWG consumer warpgroups, ST ring stages; each warpgroup owns 64 kv rows,
// dK and dV (a 64 * NWG-row kv tile).
template <int D, int NWG, int ST>
__global__ void __launch_bounds__(K3_THREADS(NWG), 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, const uint8_t* __restrict__ cls, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int B) {
  constexpr int KR = 64 * NWG;
  using Smem = DkvSmem<D, KR, ST>;
  constexpr int P = Smem::P;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));

  const int per = Hkv * B, bid = static_cast<int>(blockIdx.x);
  const int kt = bid / per, hk = bid % per % Hkv, b = bid % per / Hkv;  // first kv tiles first
  const int group = Hq / Hkv, k0 = kt * KR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 4 * NWG) {
    const int n = list_live_q_tiles(sm, cls, b, Sq, Skv, kt * (KR / TILE), (kt + 1) * (KR / TILE));
    if (lane == 0) {
      sm.nlive = n;
      for (int s = 0; s < ST; ++s) {
        mbar_init(&sm.full[s], 33);
        mbar_init(&sm.empty[s], 128 * NWG);
      }
      mbar_init(&sm.kvbar, 1);
      fence_barrier_init();
    }
  }
  __syncthreads();
  const int nlive = sm.nlive, nitems = nlive * group;

  if (warp >= 4 * NWG) {
    // ================= producer warp (of a warpgroup that gives its registers away at NWG = 2) =================
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kvbar, 2 * KR * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < KR; r += 64) {
          tma_load(sm.k[p] + r * 64, &tk, &sm.kvbar, p * 64, hk, k0 + r, b);
          tma_load(sm.v[p] + r * 64, &tv, &sm.kvbar, p * 64, hk, k0 + r, b);
        }
    }
    produce_q_items<D, ST>(sm, &tq, &tdo, lse, delta, q_grp, q_seg, 0, nitems, nlive, group, hk, b,
                           Sq, Hq);
  } else {
    // ================= consumer warpgroups =================
    if constexpr (NWG == 2) reg_alloc<240>();
    dkv_consume(sm, warp / 4 * 64, k0, nlive, nitems, kv_grp, kv_valid, kv_seg, dk, dv, Skv, Hkv,
                hk, b);
  }
}

// ---------------------------------------------------------------------------
// dK, dV at head dim 256: one block per (64-row kv tile, share of its work
// list, kv head, b), dV and dK in its two consumer warpgroups
// ---------------------------------------------------------------------------

struct Dkv256Smem {
  static constexpr int D = 256, P = D / 64, ST = 2;
  alignas(1024) bf16 k[P][64 * 64];
  alignas(1024) bf16 v[P][64 * 64];
  alignas(1024) bf16 q[ST][P][64 * 64];
  alignas(1024) bf16 dO[ST][P][64 * 64];
  float pt[32][128];  // P^T of an item: register e of consumer thread t at [e][t]
  float lse[ST][64], delta[ST][64];
  int qg[ST][64], qs[ST][64];
  uint64_t full[ST], empty[ST], kvbar, pfull, pempty;
  short live[MAX_TILES];
  uint8_t cls[MAX_TILES];
  int nlive;
};

// One warpgroup's accumulator (64 kv rows k0.. of head hk, D columns) out:
// bf16 into `out` at one share, else fp32 into this share's plane of `part`.
__device__ __forceinline__ void store_dkv256(const float (&acc)[128], bf16* __restrict__ out,
                                             float* __restrict__ part, int k0, int Skv, int Hkv,
                                             int hk, int b) {
  constexpr int D = 256;
  const int w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + w * 16 + g + 8 * r;
    if (j >= Skv) continue;
    const size_t off = ((size_t(b) * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (part == nullptr)
        *reinterpret_cast<uint32_t*>(out + off + n * 8 + 2 * t4) =
            pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      else
        *reinterpret_cast<float2*>(part + off + n * 8 + 2 * t4) =
            make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

// part: fp32 [splits, 2 (dK, dV), B, Skv, Hkv, D] when splits > 1, else unused.
__global__ void __launch_bounds__(K3_THREADS(2), 1) dkv256_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, const uint8_t* __restrict__ cls, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ part, int splits, int Sq, int Skv, int Hq, int Hkv,
    int B) {
  using Smem = Dkv256Smem;
  constexpr int D = Smem::D, P = Smem::P, ST = Smem::ST;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));

  const int per = splits * Hkv * B, bid = static_cast<int>(blockIdx.x);
  const int kt = bid / per, share = bid % per % splits;  // first kv tiles first
  const int hk = bid % per / splits % Hkv, b = bid % per / splits / Hkv;
  const int group = Hq / Hkv, k0 = kt * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 8) {
    const int n = list_live_q_tiles(sm, cls, b, Sq, Skv, kt, kt + 1);
    if (lane == 0) {
      sm.nlive = n;
      for (int s = 0; s < ST; ++s) {
        mbar_init(&sm.full[s], 33);
        mbar_init(&sm.empty[s], 256);
      }
      mbar_init(&sm.kvbar, 1);
      mbar_init(&sm.pfull, 128);
      mbar_init(&sm.pempty, 128);
      fence_barrier_init();
    }
  }
  __syncthreads();
  // this block's share of the work list: items [i0, i1)
  const int nlive = sm.nlive, nitems = nlive * group;
  const int i0 = static_cast<int>(static_cast<long long>(nitems) * share / splits);
  const int n = static_cast<int>(static_cast<long long>(nitems) * (share + 1) / splits) - i0;
  const size_t plane = size_t(B) * Skv * Hkv * D;
  float* part_k = splits > 1 ? part + (size_t(share) * 2) * plane : nullptr;
  float* part_v = splits > 1 ? part + (size_t(share) * 2 + 1) * plane : nullptr;
  const int w = warp % 4, g = lane / 4, t4 = lane % 4, ct = tid % 128;

  if (warp >= 8) {
    // ================= producer warp (of a warpgroup that gives its registers away) =================
    reg_dealloc<24>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.kvbar, 2 * 64 * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tma_load(sm.k[p], &tk, &sm.kvbar, p * 64, hk, k0, b);
        tma_load(sm.v[p], &tv, &sm.kvbar, p * 64, hk, k0, b);
      }
    }
    produce_q_items<D, ST>(sm, &tq, &tdo, lse, delta, q_grp, q_seg, i0, i0 + n, nlive, group, hk,
                           b, Sq, Hq);
  } else if (warp < 4) {
    // ================= dV: S^T = K q~^T, P^T, dV += P^T dO; P^T to the dK warpgroup =================
    reg_alloc<240>();
    int kg_r[2], kvv_r[2], ks_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + w * 16 + g + 8 * r;
      const bool in = j < Skv;
      kvv_r[r] = in ? kv_valid[size_t(b) * Skv + j] : 0;
      kg_r[r] = in ? kv_grp[size_t(b) * Skv + j] : INT_MAX;
      ks_r[r] = in && kv_seg ? kv_seg[size_t(b) * Skv + j] : 0;
    }
    float acc[D / 2], st[32], nx[32];  // nx: the next S^T, written by wgmma only
    uint32_t pa[4][4] = {};
    [[maybe_unused]] uint32_t pl[4][4] = {};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&sm.kvbar, 0);
    if (n > 0) {
      mbar_wait(&sm.full[0], 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(nx, desc_k(sm.k[kk / 4] + (kk % 4) * 16), desc_k(sm.q[0][kk / 4] + (kk % 4) * 16),
                     kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(nx);
    }
    // ptxas serializes every wgmma of the kernel (C7515) where a register a
    // wgmma accumulates into is also written by other instructions inside
    // a pipeline stage: the next item's S^T (dP^T) goes to its own array,
    // copied out after its wait, and no wgmma stays in flight across the
    // loop's back edge.
    for (int it = 0; it < n; ++it) {
      const int s = it % ST;
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = nx[e];
      // ---- P^T (fp32, masked before exp can overflow) ----
      const bool partial = sm.cls[(i0 + it) % nlive] == PARTIAL;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
          const bool ok = !partial || (kvv_r[r] && kg_r[r] <= sm.qg[s][c] && ks_r[r] == sm.qs[s][c]);
          st[4 * j + e] = ok ? __expf(st[4 * j + e] - sm.lse[s][c]) : 0.f;
        }
      mbar_wait(&sm.pempty, (it & 1) ^ 1);  // the dK warpgroup has read the last P^T
#pragma unroll
      for (int e = 0; e < 32; ++e) sm.pt[e][ct] = st[e];
      mbar_arrive(&sm.pfull);

      // ---- dV += P^T dO (A from registers, dO the transposed B), then the
      // next item's S^T queued behind it ----
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], st, kk);
        if constexpr (LO_DV) acc_rest_to_a(pl[kk], pa[kk], st, kk);
      }
      fence_regs(acc);
      fence_regs(pa);
      if constexpr (LO_DV) fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bo = desc_mn(sm.dO[s][0] + kk * 16 * 64, 64 * 64 * 2);
        wgmma_rs<D>(acc, pa[kk], bo, 1);
        if constexpr (LO_DV) wgmma_rs<D>(acc, pl[kk], bo, 1);
      }
      wgmma_commit();
      if (it + 1 < n) {
        const int s1 = (it + 1) % ST;
        mbar_wait(&sm.full[s1], ((it + 1) / ST) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64>(nx, desc_k(sm.k[kk / 4] + (kk % 4) * 16),
                       desc_k(sm.q[s1][kk / 4] + (kk % 4) * 16), kk);
        wgmma_commit();
      }
      wgmma_wait<0>();  // this item's dV and the next item's S^T
      fence_regs(nx);
      fence_regs(acc);
      fence_regs(pa);
      if constexpr (LO_DV) fence_regs(pl);
      mbar_arrive(&sm.empty[s]);
    }
    store_dkv256(acc, dv, part_v, k0, Skv, Hkv, hk, b);
  } else {
    // ================= dK: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T q~ =================
    reg_alloc<240>();
    float acc[D / 2], dpt[32], nx[32];  // nx: the next dP^T, written by wgmma only
    uint32_t da[4][4] = {};
    [[maybe_unused]] uint32_t dl[4][4] = {};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&sm.kvbar, 0);
    if (n > 0) {
      mbar_wait(&sm.full[0], 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(nx, desc_k(sm.v[kk / 4] + (kk % 4) * 16),
                     desc_k(sm.dO[0][kk / 4] + (kk % 4) * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(nx);
    }
    for (int it = 0; it < n; ++it) {
      const int s = it % ST;
#pragma unroll
      for (int e = 0; e < 32; ++e) dpt[e] = nx[e];
      mbar_wait(&sm.pfull, it & 1);  // this item's P^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t4 + (e & 1);
          dpt[4 * j + e] = sm.pt[4 * j + e][ct] * (dpt[4 * j + e] - sm.delta[s][c]);
        }
      mbar_arrive(&sm.pempty);

      // ---- dK += dS^T q~ (hi, lo), then the next item's dP^T queued behind it ----
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(da[kk], dpt, kk);
        if constexpr (LO_DK) acc_rest_to_a(dl[kk], da[kk], dpt, kk);
      }
      fence_regs(acc);
      fence_regs(da);
      if constexpr (LO_DK) fence_regs(dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bq = desc_mn(sm.q[s][0] + kk * 16 * 64, 64 * 64 * 2);
        wgmma_rs<D>(acc, da[kk], bq, 1);
        if constexpr (LO_DK) wgmma_rs<D>(acc, dl[kk], bq, 1);
      }
      wgmma_commit();
      if (it + 1 < n) {
        const int s1 = (it + 1) % ST;
        mbar_wait(&sm.full[s1], ((it + 1) / ST) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64>(nx, desc_k(sm.v[kk / 4] + (kk % 4) * 16),
                       desc_k(sm.dO[s1][kk / 4] + (kk % 4) * 16), kk);
        wgmma_commit();
      }
      wgmma_wait<0>();  // this item's dK and the next item's dP^T
      fence_regs(nx);
      fence_regs(acc);
      fence_regs(da);
      if constexpr (LO_DK) fence_regs(dl);
      mbar_arrive(&sm.empty[s]);
    }
    store_dkv256(acc, dk, part_k, k0, Skv, Hkv, hk, b);
  }
}

// dK and dV from the shares' fp32 partials, added in share order: four
// elements a thread, dK's then dV's.
__global__ void __launch_bounds__(256) dkv_sum_kernel(const float4* __restrict__ part, int splits,
                                                      size_t n4, uint2* __restrict__ dk,
                                                      uint2* __restrict__ dv) {
  const size_t i = size_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const size_t t = i / n4, e = i % n4;  // t: 0 dK, 1 dV
  float4 a = part[t * n4 + e];
  for (int s = 1; s < splits; ++s) {
    const float4 x = part[(size_t(s) * 2 + t) * n4 + e];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  (t ? dv : dk)[e] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// ---------------------------------------------------------------------------
// dQ: one block per (64 * NWG-row q tile, q head, b)
// ---------------------------------------------------------------------------

template <int D, int BQ, int ST>
struct DqSmem {
  static constexpr int P = D / 64, BK = 64;  // kv rows a tile
  alignas(1024) bf16 q[P][BQ * 64];
  alignas(1024) bf16 dO[P][BQ * 64];
  alignas(1024) bf16 k[ST][P][BK * 64];
  alignas(1024) bf16 v[ST][P][BK * 64];
  int kg[ST][BK], kvld[ST][BK], ks[ST][BK];
  uint64_t full[ST], empty[ST], qbar;
  short live[MAX_TILES];
  uint8_t cls[MAX_TILES];
  int nlive;
};

template <int D, int NWG, int ST>
__global__ void __launch_bounds__(K3_THREADS(NWG), 1) dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, const uint8_t* __restrict__ cls, bf16* __restrict__ dq,
    int Sq, int Skv, int Hq, int Hkv, int B, float scale) {
  constexpr int BQ = 64 * NWG;
  using Smem = DqSmem<D, BQ, ST>;
  constexpr int P = Smem::P, BK = Smem::BK;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));

  const int nqt = (Sq + BQ - 1) / BQ, hb = Hq * B;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / hb;  // heaviest q tiles first
  const int h = static_cast<int>(blockIdx.x) % hb % Hq, b = static_cast<int>(blockIdx.x) % hb / Hq;
  const int hk = h / (Hq / Hkv), q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 4 * NWG) {
    // ---- the live kv tiles of this q tile ----
    const int nq64 = (Sq + TILE - 1) / TILE, nk64 = (Skv + TILE - 1) / TILE;
    const uint8_t* map = cls + size_t(b) * nq64 * nk64;
    int n = 0;
    const int nkt = (Skv + BK - 1) / BK;
    for (int t0 = 0; t0 < nkt; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < nkt ? tile_class(map, nq64, nk64, qt * NWG, (qt + 1) * NWG,
                                         t * (BK / TILE), (t + 1) * (BK / TILE))
                            : DEAD;
      const unsigned live = __ballot_sync(0xffffffffu, c != DEAD);
      if (c != DEAD) {
        const int pos = n + __popc(live & ((1u << lane) - 1));
        sm.live[pos] = static_cast<short>(t);
        sm.cls[pos] = static_cast<uint8_t>(c);
      }
      n += __popc(live);
    }
    if (lane == 0) {
      sm.nlive = n;
      for (int s = 0; s < ST; ++s) {
        mbar_init(&sm.full[s], 33);
        mbar_init(&sm.empty[s], 128 * NWG);
      }
      mbar_init(&sm.qbar, 1);
      fence_barrier_init();
    }
  }
  __syncthreads();
  const int nlive = sm.nlive;

  if (warp >= 4 * NWG) {
    // ================= producer warp (of a warpgroup that gives its registers away at NWG = 2) =================
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qbar, 2 * BQ * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < BQ; r += 64) {
          tma_load(sm.q[p] + r * 64, &tq, &sm.qbar, p * 64, h, q0 + r, b);
          tma_load(sm.dO[p] + r * 64, &tdo, &sm.qbar, p * 64, h, q0 + r, b);
        }
    }
    const int* kvg = kv_grp + size_t(b) * Skv;
    const int* kvv = kv_valid + size_t(b) * Skv;
    const int* kvs = kv_seg ? kv_seg + size_t(b) * Skv : nullptr;
    for (int it = 0; it < nlive; ++it) {
      const int s = it % ST, j0 = sm.live[it] * BK;
      mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * BK * D * 2);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < BK; r += 64) {
            tma_load(sm.k[s][p] + r * 64, &tk, &sm.full[s], p * 64, hk, j0 + r, b);
            tma_load(sm.v[s][p] + r * 64, &tv, &sm.full[s], p * 64, hk, j0 + r, b);
          }
      }
      for (int r = lane; r < BK; r += 32) {
        const int j = j0 + r;
        const bool in = j < Skv;
        sm.kg[s][r] = in ? kvg[j] : 0;
        sm.kvld[s][r] = in ? kvv[j] : 0;
        sm.ks[s][r] = in && kvs ? kvs[j] : 0;
      }
      mbar_arrive(&sm.full[s]);
    }
  } else {
    // ================= consumer warpgroups: 64 q rows each =================
    if constexpr (NWG == 2) reg_alloc<240>();
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t4 = lane % 4;
    int qg_r[2], qs_r[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + wg * 64 + w * 16 + g + 8 * r;
      const bool in = i < Sq;
      qg_r[r] = in ? q_grp[size_t(b) * Sq + i] : INT_MIN;
      qs_r[r] = in && q_seg ? q_seg[size_t(b) * Sq + i] : 0;
      lse_r[r] = in ? lse[(size_t(b) * Hq + h) * Sq + i] : INFINITY;
      delta_r[r] = in ? delta[(size_t(b) * Hq + h) * Sq + i] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&sm.qbar, 0);

    for (int it = 0; it < nlive; ++it) {
      const int s = it % ST;
      mbar_wait(&sm.full[s], (it / ST) & 1);

      // ---- S = q~ K^T, then dP = dO V^T (64 q rows x BK kv columns) ----
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 16;
        wgmma_ss<BK>(sc, desc_k(sm.q[p] + wg * 64 * 64 + off), desc_k(sm.k[s][p] + off), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 16;
        wgmma_ss<BK>(dp, desc_k(sm.dO[p] + wg * 64 * 64 + off), desc_k(sm.v[s][p] + off), kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP still runs
      fence_regs(sc);

      // ---- P, masked before exp can overflow; then dS = P (dP - delta) ----
      const bool partial = sm.cls[it] == PARTIAL;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
          const bool ok =
              !partial || (sm.kvld[s][c] && sm.kg[s][c] <= qg_r[r] && sm.ks[s][c] == qs_r[r]);
          sc[4 * j + e] = ok ? __expf(sc[4 * j + e] - lse_r[r]) : 0.f;
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - delta_r[e >> 1]);

      // ---- dQ += dS K (A from registers, K as the transposed B) ----
      uint32_t da[BK / 16][4];
      [[maybe_unused]] uint32_t dl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        acc_to_a(da[kk], dp, kk);
        if constexpr (LO_DQ) acc_rest_to_a(dl[kk], da[kk], dp, kk);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = desc_mn(sm.k[s][0] + kk * 16 * 64, BK * 64 * 2);
        wgmma_rs<D>(acc, da[kk], bk, 1);
        if constexpr (LO_DQ) wgmma_rs<D>(acc, dl[kk], bk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      if constexpr (LO_DQ) fence_regs(dl);
      mbar_arrive(&sm.empty[s]);
    }

    // ---- dq = scale * acc (the products were taken w.r.t. the scaled q~) ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + wg * 64 + w * 16 + g + 8 * r;
      if (i >= Sq) continue;
      bf16* row = dq + ((size_t(b) * Sq + i) * Hq + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t4) =
            pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ at head dim 256: one block per (64-row q tile, q head, b), heaviest
// first; warpgroup 1 forms dS, warpgroup 2 accumulates dQ
// ---------------------------------------------------------------------------

struct Dq256Smem {
  static constexpr int D = 256, P = D / 64, ST = 2, BK = 64;
  alignas(1024) bf16 q[P][64 * 64];
  alignas(1024) bf16 dO[P][64 * 64];
  alignas(1024) bf16 k[ST][P][BK * 64];
  alignas(1024) bf16 v[ST][P][BK * 64];
  float ds[32][128];  // dS of an item: register e of consumer thread t at [e][t]
  int kg[ST][BK], kvld[ST][BK], ks[ST][BK];
  uint64_t full[ST], empty[ST], qbar, dsfull, dsempty;
  short live[MAX_TILES];
  uint8_t cls[MAX_TILES];
  int nlive;
};

// Warpgroup 1: S = q~ K^T and dP = dO V^T of the next kv tile queued while
// it forms this one's P and dS = P (dP - delta), handed to warpgroup 2 in
// fp32; warpgroup 2: dQ += dS K (hi + lo).  The products and their dS are
// dq_kernel's, in the same order: the same bits.
__global__ void __launch_bounds__(K3_THREADS(2), 1) dq256_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, const uint8_t* __restrict__ cls, bf16* __restrict__ dq,
    int Sq, int Skv, int Hq, int Hkv, int B, float scale) {
  using Smem = Dq256Smem;
  constexpr int D = Smem::D, P = Smem::P, ST = Smem::ST, BK = Smem::BK;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));

  const int nqt = (Sq + 63) / 64, hb = Hq * B;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / hb;  // heaviest q tiles first
  const int h = static_cast<int>(blockIdx.x) % hb % Hq, b = static_cast<int>(blockIdx.x) % hb / Hq;
  const int hk = h / (Hq / Hkv), q0 = qt * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 8) {
    // ---- the live kv tiles of this q tile ----
    const int nq64 = (Sq + TILE - 1) / TILE, nk64 = (Skv + TILE - 1) / TILE;
    const uint8_t* map = cls + size_t(b) * nq64 * nk64;
    int n = 0;
    for (int t0 = 0; t0 < nk64; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < nk64 ? tile_class(map, nq64, nk64, qt, qt + 1, t, t + 1) : DEAD;
      const unsigned live = __ballot_sync(0xffffffffu, c != DEAD);
      if (c != DEAD) {
        const int pos = n + __popc(live & ((1u << lane) - 1));
        sm.live[pos] = static_cast<short>(t);
        sm.cls[pos] = static_cast<uint8_t>(c);
      }
      n += __popc(live);
    }
    if (lane == 0) {
      sm.nlive = n;
      for (int s = 0; s < ST; ++s) {
        mbar_init(&sm.full[s], 33);
        mbar_init(&sm.empty[s], 256);
      }
      mbar_init(&sm.qbar, 1);
      mbar_init(&sm.dsfull, 128);
      mbar_init(&sm.dsempty, 128);
      fence_barrier_init();
    }
  }
  __syncthreads();
  const int nlive = sm.nlive;
  const int w = warp % 4, g = lane / 4, t4 = lane % 4, ct = tid % 128;

  if (warp >= 8) {
    // ================= producer warp (of a warpgroup that gives its registers away) =================
    reg_dealloc<24>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qbar, 2 * 64 * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tma_load(sm.q[p], &tq, &sm.qbar, p * 64, h, q0, b);
        tma_load(sm.dO[p], &tdo, &sm.qbar, p * 64, h, q0, b);
      }
    }
    const int* kvg = kv_grp + size_t(b) * Skv;
    const int* kvv = kv_valid + size_t(b) * Skv;
    const int* kvs = kv_seg ? kv_seg + size_t(b) * Skv : nullptr;
    for (int it = 0; it < nlive; ++it) {
      const int s = it % ST, j0 = sm.live[it] * BK;
      mbar_wait(&sm.empty[s], ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[s], 2 * BK * D * 2);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(sm.k[s][p], &tk, &sm.full[s], p * 64, hk, j0, b);
          tma_load(sm.v[s][p], &tv, &sm.full[s], p * 64, hk, j0, b);
        }
      }
      for (int r = lane; r < BK; r += 32) {
        const int j = j0 + r;
        const bool in = j < Skv;
        sm.kg[s][r] = in ? kvg[j] : 0;
        sm.kvld[s][r] = in ? kvv[j] : 0;
        sm.ks[s][r] = in && kvs ? kvs[j] : 0;
      }
      mbar_arrive(&sm.full[s]);
    }
  } else if (warp < 4) {
    // ================= dS: S, P, dP, dS of each kv tile; dS to the dQ warpgroup =================
    reg_alloc<240>();
    int qg_r[2], qs_r[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + w * 16 + g + 8 * r;
      const bool in = i < Sq;
      qg_r[r] = in ? q_grp[size_t(b) * Sq + i] : INT_MIN;
      qs_r[r] = in && q_seg ? q_seg[size_t(b) * Sq + i] : 0;
      lse_r[r] = in ? lse[(size_t(b) * Hq + h) * Sq + i] : INFINITY;
      delta_r[r] = in ? delta[(size_t(b) * Hq + h) * Sq + i] : 0.f;
    }
    // ns, ndp: the next tile's S and dP, written by wgmma only (see dkv256_kernel)
    float sc[BK / 2], dp[BK / 2], ns[BK / 2], ndp[BK / 2];
    mbar_wait(&sm.qbar, 0);
    if (nlive > 0) {
      mbar_wait(&sm.full[0], 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(ns, desc_k(sm.q[kk / 4] + (kk % 4) * 16), desc_k(sm.k[0][kk / 4] + (kk % 4) * 16),
                     kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(ndp, desc_k(sm.dO[kk / 4] + (kk % 4) * 16),
                     desc_k(sm.v[0][kk / 4] + (kk % 4) * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ns);
      fence_regs(ndp);
    }
    for (int it = 0; it < nlive; ++it) {
      const int s = it % ST;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        sc[e] = ns[e];
        dp[e] = ndp[e];
      }
      // ---- P, masked before exp can overflow; then dS = P (dP - delta) ----
      const bool partial = sm.cls[it] == PARTIAL;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
          const bool ok =
              !partial || (sm.kvld[s][c] && sm.kg[s][c] <= qg_r[r] && sm.ks[s][c] == qs_r[r]);
          sc[4 * j + e] = ok ? __expf(sc[4 * j + e] - lse_r[r]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - delta_r[e >> 1]);
      mbar_wait(&sm.dsempty, (it & 1) ^ 1);  // the dQ warpgroup has read the last dS
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sm.ds[e][ct] = dp[e];
      mbar_arrive(&sm.dsfull);
      mbar_arrive(&sm.empty[s]);  // done with stage s (its products ran in the last iteration)

      // ---- the next kv tile's S and dP ----
      if (it + 1 < nlive) {
        const int s1 = (it + 1) % ST;
        mbar_wait(&sm.full[s1], ((it + 1) / ST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(ns, desc_k(sm.q[kk / 4] + (kk % 4) * 16),
                       desc_k(sm.k[s1][kk / 4] + (kk % 4) * 16), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(ndp, desc_k(sm.dO[kk / 4] + (kk % 4) * 16),
                       desc_k(sm.v[s1][kk / 4] + (kk % 4) * 16), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ns);
        fence_regs(ndp);
      }
    }
  } else {
    // ================= dQ += dS K (A from registers, K as the transposed B) =================
    reg_alloc<240>();
    float acc[D / 2], t[BK / 2];
    uint32_t da[BK / 16][4] = {};
    [[maybe_unused]] uint32_t dl[BK / 16][4] = {};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < nlive; ++it) {
      const int s = it % ST;
      mbar_wait(&sm.dsfull, it & 1);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) t[e] = sm.ds[e][ct];
      mbar_arrive(&sm.dsempty);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        acc_to_a(da[kk], t, kk);
        if constexpr (LO_DQ) acc_rest_to_a(dl[kk], da[kk], t, kk);
      }
      mbar_wait(&sm.full[s], (it / ST) & 1);  // K of this tile, as the dS warpgroup saw it
      fence_regs(acc);
      fence_regs(da);
      if constexpr (LO_DQ) fence_regs(dl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = desc_mn(sm.k[s][0] + kk * 16 * 64, BK * 64 * 2);
        wgmma_rs<D>(acc, da[kk], bk, 1);
        if constexpr (LO_DQ) wgmma_rs<D>(acc, dl[kk], bk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      if constexpr (LO_DQ) fence_regs(dl);
      mbar_arrive(&sm.empty[s]);
    }

    // ---- dq = scale * acc (the products were taken w.r.t. the scaled q~) ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + w * 16 + g + 8 * r;
      if (i >= Sq) continue;
      bf16* row = dq + ((size_t(b) * Sq + i) * Hq + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t4) =
            pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

// KV_*: dkv_kernel's consumer warpgroups and ring stages, Q_*: dq_kernel's
// (head dims 64 and 128; head dim 256 takes dkv256_kernel with `splits` and
// dq256_kernel, two consumer warpgroups and two stages each).
template <int D, int KV_NWG, int KV_ST, int Q_NWG, int Q_ST>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
                   long long do_sb, long long do_ss, long long do_sh, const float* lse,
                   const int* q_grp, const int* kv_grp, const int* kv_valid, const int* q_seg,
                   const int* kv_seg, void* dq, void* dk, void* dv, void* qs, float* delta,
                   uint8_t* cls, float* part, int splits, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, cudaStream_t stream) {
  constexpr int KR = D == 256 ? 64 : 64 * KV_NWG, BQ = 64 * Q_NWG;
  CUtensorMap tq, tdo, tk, tv;  // 64-row boxes; a larger tile is several
  if (!make_map(&tq, qs, B, Sq, Hq, D) ||
      !make_map(&tdo, dout, B, Sq, Hq, D, do_sb, do_ss, do_sh) ||
      !make_map(&tk, k, B, Skv, Hkv, D) || !make_map(&tv, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(dbx_flash_tile_classes(
      q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls, B, Sq, Skv, static_cast<void*>(stream)));
  if (err != cudaSuccess) return err;
  const size_t rows = size_t(B) * Sq * Hq;
  pre_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      do_sb, do_ss, do_sh, static_cast<bf16*>(qs), delta, B, Sq, Hq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv =
      (D == 256 ? int(sizeof(Dkv256Smem)) : int(sizeof(DkvSmem<D, KR, KV_ST>))) + 1024;
  const int smem_q = (D == 256 ? int(sizeof(Dq256Smem)) : int(sizeof(DqSmem<D, BQ, Q_ST>))) + 1024;
  cudaError_t attr_kv, attr_q;  // each attribute set once per instance
  if constexpr (D == 256) {
    static const cudaError_t a[2] = {
        cudaFuncSetAttribute(dkv256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv),
        cudaFuncSetAttribute(dq256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q)};
    attr_kv = a[0];
    attr_q = a[1];
  } else {
    static const cudaError_t a[2] = {
        cudaFuncSetAttribute(dkv_kernel<D, KV_NWG, KV_ST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv),
        cudaFuncSetAttribute(dq_kernel<D, Q_NWG, Q_ST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q)};
    attr_kv = a[0];
    attr_q = a[1];
  }
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  if constexpr (D == 256) {
    dkv256_kernel<<<(Skv + KR - 1) / KR * splits * Hkv * B, K3_THREADS(2), smem_kv, stream>>>(
        tq, tdo, tk, tv, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, splits, Sq, Skv, Hq, Hkv, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (splits > 1) {
      const size_t n4 = size_t(B) * Skv * Hkv * D / 4;
      dkv_sum_kernel<<<static_cast<unsigned>((2 * n4 + 255) / 256), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), splits, n4, static_cast<uint2*>(dk),
          static_cast<uint2*>(dv));
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    dq256_kernel<<<(Sq + 63) / 64 * Hq * B, K3_THREADS(2), smem_q, stream>>>(
        tq, tdo, tk, tv, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls,
        static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, B, scale);
  } else {
    dkv_kernel<D, KV_NWG, KV_ST><<<(Skv + KR - 1) / KR * Hkv * B, K3_THREADS(KV_NWG), smem_kv,
                                   stream>>>(
        tq, tdo, tk, tv, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv, B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_kernel<D, Q_NWG, Q_ST><<<(Sq + BQ - 1) / BQ * Hq * B, K3_THREADS(Q_NWG), smem_q, stream>>>(
        tq, tdo, tk, tv, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls,
        static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, B, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous [B, S, H, D] bf16; dout: bf16 with element strides
// (do_sb, do_ss, do_sh, 1); lse fp32 [B, Hq, Sq].  Scratch from the caller:
// qs (like q), delta (fp32 [B, Hq, Sq]), cls (B * ceil(Sq/64) * ceil(Skv/64)
// bytes) and, at head dim 256 with splits > 1, part (fp32 [splits, 2, B,
// Skv, Hkv, D]).  Head dims 64, 128 and 256; splits (the blocks that share a
// kv tile's work list) is 1 except at 256, where it is at most 16.
extern "C" int dbx_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, const void* q_grp,
                             const void* kv_grp, const void* kv_valid, const void* q_seg,
                             const void* kv_seg, void* dq, void* dk, void* dv, void* qs,
                             void* delta, void* cls, void* part, int B, int Sq, int Skv, int Hq,
                             int Hkv, int D, int splits, float scale, long long do_sb,
                             long long do_ss, long long do_sh, void* stream) {
  if (Skv < 1 || Skv > MAX_TILES * TILE || Sq < 1 || Sq > MAX_TILES * TILE || Hkv < 1 ||
      Hq % Hkv || B < 1 || splits < 1 || splits > (D == 256 ? 16 : 1) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto qg = static_cast<const int*>(q_grp), kg = static_cast<const int*>(kv_grp);
  auto kvv = static_cast<const int*>(kv_valid);
  auto qsg = static_cast<const int*>(q_seg), ksg = static_cast<const int*>(kv_seg);
  auto dl = static_cast<float*>(delta);
  auto c = static_cast<uint8_t*>(cls);
  auto pt = static_cast<float*>(part);
  if (D == 128)
    return launch<128, 2, 3, 2, 3>(q, k, v, out, dout, do_sb, do_ss, do_sh, l, qg, kg, kvv, qsg,
                                   ksg, dq, dk, dv, qs, dl, c, pt, 1, B, Sq, Skv, Hq, Hkv, scale,
                                   st);
  if (D == 64)
    return launch<64, 2, 3, 2, 3>(q, k, v, out, dout, do_sb, do_ss, do_sh, l, qg, kg, kvv, qsg,
                                  ksg, dq, dk, dv, qs, dl, c, pt, 1, B, Sq, Skv, Hq, Hkv, scale, st);
  if (D == 256)  // see the header: dkv256_kernel and dq256_kernel, 2 stages each
    return launch<256, 2, 2, 2, 2>(q, k, v, out, dout, do_sb, do_ss, do_sh, l, qg, kg, kvv, qsg,
                                   ksg, dq, dk, dv, qs, dl, c, pt, splits, B, Sq, Skv, Hq, Hkv,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
