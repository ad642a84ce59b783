// K1: masked grouped-query flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels dexbotic_tpu/ops/attention.py:_flash_kernel
// (multi-block online softmax) and :_flash_kernel_single (whole-sequence
// softmax).  Their split existed for TPU grid overheads; here one kernel with
// an online softmax over kv tiles serves every length.
//
// What it computes, per (batch b, query head h): softmax(q k^T * scale) v with
// the mask rebuilt from int vectors: query i sees key j iff
// kv_grp[j] <= q_grp[i] && kv_valid[j] && q_seg[i] == kv_seg[j].  GQA maps
// query head h to kv head h / (Hq / Hkv).  Rows with no visible key give 0.
// Writes O (bf16, [B, Sq, Hq, D]) and the per-row log-sum-exp (fp32,
// [B, Hq, Sq]) for a later backward.
//
// What bounds it on the card: about 4*S^2*D flops per (b, h) against 4*S*D
// bytes, so the tensor cores, reachable at full rate only through wgmma.
// Design (FlashAttention-3's forward, without its intra-warpgroup overlap):
//  * a pre-pass (tile_class_kernel) classes every (64-row q tile, 64-row kv
//    tile) pair as dead, partial or wholly visible; each block lists the live
//    kv tiles of its q tile from that map, so dead tiles are never loaded and
//    visible ones skip the per-element mask test;
//  * one block per (q tile of 64 * NWG rows, h, b), the heaviest q tiles
//    (the last, under a causal mask) first;
//  * one producer warp (of its own warpgroup when NWG = 2, which gives its
//    registers to the consumers by setmaxnreg) loads the Q tile, then
//    streams K and V tiles of BK rows by TMA into 128-byte-swizzled shared
//    memory through a ring of stages handed over by mbarriers (full: TMA
//    bytes + the tile's mask vectors written by the warp; empty: every
//    consumer thread);
//  * NWG consumer warpgroups of 64 query rows: Q is pre-scaled in place once
//    it lands (bf16(float(q) * scale), as _flash_impl does), then per tile
//    S = Q K^T by wgmma from shared memory, the fp32 online softmax in
//    registers (exp2 with the log2(e) factor fused; O rescaled only when a
//    row's max moved), and O += P V by wgmma with P (bf16) straight from the
//    score registers and V as the transposed B operand.
// NWG = 2 with BK = 128 for large grids, NWG = 1 with BK = 64 (two blocks an
// SM) for small ones: the wrapper picks by the number of blocks (PERF.md).
// Head dims 64, 128 and 256; at 256 both shapes take BK = 64 and one block
// an SM, and O += P V is one m64n256k16 wgmma a 16-key step.

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr int MAX_TILES = 256;  // 64-row kv tiles: Skv <= 16384
constexpr float NEG = -2.3819763e38f;  // constants.MASKED_BIAS
constexpr float L2E = 1.4426950408889634f;  // exp(x) = exp2(x * L2E)

template <int D, int NWG, int BK>
struct FwdSmem {
  static constexpr int P = D / 64, BQ = 64 * NWG;
  static constexpr int STAGES = 2;
  alignas(1024) bf16 q[P][BQ * 64];
  alignas(1024) bf16 k[STAGES][P][BK * 64];
  alignas(1024) bf16 v[STAGES][P][BK * 64];
  int kg[STAGES][BK], kvld[STAGES][BK], ks[STAGES][BK];
  uint64_t full[STAGES], empty[STAGES], qbar;
  short live[MAX_TILES];
  uint8_t cls[MAX_TILES];
  int nlive;
};

// Class of (64-row q tile, 64-row kv tile) pairs, from the int vectors:
// DEAD when no query row sees a key of the tile, VISIBLE when every query
// row (of those < Sq) sees every key (so every key row is < Skv and valid),
// PARTIAL otherwise.  grid (kv tiles, q tiles, B), 256 threads: thread
// 4 r + c tests query row r against 16 keys.  cls is [B, q tiles, kv tiles].
__global__ void __launch_bounds__(256) tile_class_kernel(
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, uint8_t* __restrict__ cls, int Sq, int Skv) {
  __shared__ int kg[TILE], kvv[TILE], ks[TILE];
  const int kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  if (tid < TILE) {
    const int j = kt * TILE + tid;
    const bool in = j < Skv;
    kg[tid] = in ? kv_grp[size_t(b) * Skv + j] : 0;
    kvv[tid] = in && kv_valid[size_t(b) * Skv + j] != 0;
    ks[tid] = in && kv_seg ? kv_seg[size_t(b) * Skv + j] : 0;
  }
  __syncthreads();
  const int i = qt * TILE + tid / 4, c0 = (tid % 4) * 16;
  bool any = false, all = true;
  if (i < Sq) {
    const int qg = q_grp[size_t(b) * Sq + i], qs = q_seg ? q_seg[size_t(b) * Sq + i] : 0;
#pragma unroll
    for (int c = c0; c < c0 + 16; ++c) {
      const bool ok = kvv[c] && kg[c] <= qg && ks[c] == qs;
      any |= ok;
      all &= ok;
    }
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  if (tid == 0)
    cls[(size_t(b) * gridDim.y + qt) * gridDim.x + kt] = any ? (all ? VISIBLE : PARTIAL) : DEAD;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Blocks an SM: two one-warpgroup blocks at D <= 128; one block at D = 256,
// whose O accumulator alone is 128 fp32 a thread (two blocks would cap the
// registers near 204 and spill) and whose tiles take 160-192 KB of shared
// memory.  (Arithmetic, not ?:, which nvcc's host stub rejects here.)
template <int D, int NWG, int BK>
__global__ void __launch_bounds__(128 * NWG + 32 + 96 * (NWG - 1),
                                  3 - NWG - (D / 256) * (2 - NWG)) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_grp,
    const int* __restrict__ kv_grp, const int* __restrict__ kv_valid,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    const uint8_t* __restrict__ cls, bf16* __restrict__ o, float* __restrict__ lse, int Sq,
    int Skv, int Hq, int Hkv, int B, float scale) {
  using Smem = FwdSmem<D, NWG, BK>;
  constexpr int P = Smem::P, BQ = Smem::BQ, STAGES = Smem::STAGES;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));

  const int nqt = (Sq + BQ - 1) / BQ, hb = Hq * B;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / hb;  // heaviest q tiles first
  const int h = static_cast<int>(blockIdx.x) % hb % Hq, b = static_cast<int>(blockIdx.x) % hb / Hq;
  const int hk = h / (Hq / Hkv), q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 4 * NWG) {
    // ---- the live kv tiles of this q tile, from the class map ----
    const int nq64 = (Sq + TILE - 1) / TILE, nk64 = (Skv + TILE - 1) / TILE;
    const int nkt = (Skv + BK - 1) / BK;
    const uint8_t* map = cls + size_t(b) * nq64 * nk64;
    int n = 0;
    for (int t0 = 0; t0 < nkt; t0 += 32) {
      const int t = t0 + lane;
      const int c = t < nkt ? tile_class(map, nq64, nk64, q0 / TILE, q0 / TILE + NWG,
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
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], 33);  // the TMA issue + 32 lanes' mask vectors
        mbar_init(&sm.empty[s], 128 * NWG);
      }
      mbar_init(&sm.qbar, 1);
      fence_barrier_init();
    }
  }
  __syncthreads();
  const int nlive = sm.nlive;

  if (warp >= 4 * NWG) {
    // ================= producer warp (of a warpgroup when NWG = 2) =================
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (warp > 4 * NWG) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.qbar, BQ * D * 2);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < BQ; r += 64) tma_load(sm.q[p] + r * 64, &tq, &sm.qbar, p * 64, h, q0 + r, b);
    }
    const int* kvg = kv_grp + size_t(b) * Skv;
    const int* kvv = kv_valid + size_t(b) * Skv;
    const int* kvs = kv_seg ? kv_seg + size_t(b) * Skv : nullptr;
    for (int it = 0; it < nlive; ++it) {
      const int s = it % STAGES, j0 = sm.live[it] * BK;
      mbar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
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
      for (int r = lane; r < BK; r += 32) {  // rows past Skv: invalid
        const int j = j0 + r;
        const bool in = j < Skv;
        sm.kg[s][r] = in ? kvg[j] : 0;
        sm.kvld[s][r] = in ? kvv[j] : 0;
        sm.ks[s][r] = in && kvs ? kvs[j] : 0;
      }
      mbar_arrive(&sm.full[s]);
    }
  } else {
    // ================= consumer warpgroups =================
    if constexpr (NWG == 2) reg_alloc<240>();
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t4 = lane % 4, wtid = tid % 128;
    int qg_r[2], qs_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + wg * 64 + w * 16 + g + 8 * r;
      qg_r[r] = i < Sq ? q_grp[size_t(b) * Sq + i] : INT_MIN;
      qs_r[r] = i < Sq && q_seg ? q_seg[size_t(b) * Sq + i] : 0;
    }

    // ---- this warpgroup's Q rows, pre-scaled in place ----
    mbar_wait(&sm.qbar, 0);
    for (int u = wtid; u < 64 * D / 8; u += 128) {
      uint4* ptr = reinterpret_cast<uint4*>(sm.q[u / 512] + wg * 64 * 64) + u % 512;
      uint4 raw = *ptr;
      uint32_t* w32 = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w32[e]);
        w32[e] = pack_bf16(__low2float(x) * scale, __high2float(x) * scale);
      }
      *ptr = raw;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};  // l: this thread's partial row sums

    for (int it = 0; it < nlive; ++it) {
      const int s = it % STAGES;
      mbar_wait(&sm.full[s], (it / STAGES) & 1);

      // ---- S = Q K^T (64 x BK per warpgroup) ----
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 16;
        wgmma_ss<BK>(sc, desc_k(sm.q[p] + wg * 64 * 64 + off), desc_k(sm.k[s][p] + off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // ---- mask (partial tiles only), online softmax in fp32 ----
      if (sm.cls[it] == PARTIAL) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
            const bool ok = sm.kvld[s][c] && sm.kg[s][c] <= qg_r[r] && sm.ks[s][c] == qs_r[r];
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      float corr[2], rs[2] = {0.f, 0.f}, ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
        corr[r] = m_r[r] == NEG ? 0.f : exp2f((m_r[r] - m_new) * L2E);
        m_r[r] = m_new;
        ms[r] = m_new == NEG ? 0.f : m_new * L2E;  // a row masked so far: every p is exp2(-inf)
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], L2E, -ms[e >> 1]));
          rs[e >> 1] += sc[4 * j + e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rs[r];
      // O is rescaled only where a row's max moved (corr is then != 1; a
      // warp-uniform test: after the first tiles the max rarely moves)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 0] *= corr[0];
          acc[4 * j + 1] *= corr[0];
          acc[4 * j + 2] *= corr[1];
          acc[4 * j + 3] *= corr[1];
        }
      }

      // ---- O += P V: P (bf16) from the score registers, V transposed B ----
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], sc, kk);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_mn(sm.v[s][0] + kk * 16 * 64, BK * 64 * 2), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&sm.empty[s]);
    }

    // ---- finalize: O / l, LSE = m + log(l); rows that see no key give 0 ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + wg * 64 + w * 16 + g + 8 * r;
      const float denom = fmaxf(quad_sum(l_r[r]), 1e-30f);
      if (i >= Sq) continue;
      const float inv = 1.f / denom;
      bf16* orow = o + ((size_t(b) * Sq + i) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if (t4 == 0) lse[(size_t(b) * Hq + h) * Sq + i] = m_r[r] + logf(denom);
    }
  }
}

template <int D, int NWG, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_grp,
                   const int* kv_grp, const int* kv_valid, const int* q_seg, const int* kv_seg,
                   uint8_t* cls, void* o, float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;  // 64-row boxes: a larger tile is several
  if (!make_map(&tq, q, B, Sq, Hq, D) || !make_map(&tk, k, B, Skv, Hkv, D) ||
      !make_map(&tv, v, B, Skv, Hkv, D))
    return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(
      dbx_flash_tile_classes(q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls, B, Sq, Skv,
                             static_cast<void*>(stream)));
  if (err != cudaSuccess) return err;
  const int smem = sizeof(FwdSmem<D, NWG, BK>) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      flash_fwd_kernel<D, NWG, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int blocks = (Sq + 64 * NWG - 1) / (64 * NWG) * Hq * B;
  flash_fwd_kernel<D, NWG, BK><<<blocks, NWG == 2 ? 384 : 160, smem, stream>>>(
      tq, tk, tv, q_grp, kv_grp, kv_valid, q_seg, kv_seg, cls, static_cast<bf16*>(o), lse, Sq,
      Skv, Hq, Hkv, B, scale);
  return cudaGetLastError();
}

}  // namespace

// cls: scratch of B * ceil(Sq / 64) * ceil(Skv / 64) bytes; rows: 64 or 128
// query rows a block.
extern "C" int dbx_flash_fwd(const void* q, const void* k, const void* v, const void* q_grp,
                             const void* kv_grp, const void* kv_valid, const void* q_seg,
                             const void* kv_seg, void* o, void* lse, void* cls, int B, int Sq,
                             int Skv, int Hq, int Hkv, int D, float scale, int rows,
                             void* stream) {
  if (Skv < 1 || Skv > MAX_TILES * TILE || Sq < 1 || Hkv < 1 || Hq % Hkv || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto qg = static_cast<const int*>(q_grp), kg = static_cast<const int*>(kv_grp);
  auto kvv = static_cast<const int*>(kv_valid);
  auto qs = static_cast<const int*>(q_seg), ks = static_cast<const int*>(kv_seg);
  auto c = static_cast<uint8_t*>(cls);
  auto l = static_cast<float*>(lse);
  if (D == 128 && rows == 128)
    return launch<128, 2, 128>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  if (D == 128 && rows == 64)
    return launch<128, 1, 64>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  if (D == 64 && rows == 128)
    return launch<64, 2, 128>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  if (D == 64 && rows == 64)
    return launch<64, 1, 64>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  // D = 256: 64-row kv tiles (four panels each of K and V a stage: a
  // 128-row tile would need ~320 KB of shared memory)
  if (D == 256 && rows == 128)
    return launch<256, 2, 64>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  if (D == 256 && rows == 64)
    return launch<256, 1, 64>(q, k, v, qg, kg, kvv, qs, ks, c, o, l, B, Sq, Skv, Hq, Hkv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The class map of K1 and K3 (the tests hold it against its plain version).
extern "C" int dbx_flash_tile_classes(const void* q_grp, const void* kv_grp, const void* kv_valid,
                                      const void* q_seg, const void* kv_seg, void* cls, int B,
                                      int Sq, int Skv, void* stream) {
  const dim3 grid((Skv + TILE - 1) / TILE, (Sq + TILE - 1) / TILE, B);
  tile_class_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_grp), static_cast<const int*>(kv_grp),
      static_cast<const int*>(kv_valid), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<uint8_t*>(cls), Sq, Skv);
  return static_cast<int>(cudaGetLastError());
}
