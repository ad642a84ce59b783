// K3: masked grouped-query flash-attention backward for Hopper (sm_90a).
//
// Replaces the four TPU backward kernels of dexbotic_tpu/ops/attention.py:
// _flash_bwd_single_kernel (whole sequence), _flash_bwd_fused_kernel (one
// pass writing per-kv-block dq partials) and the split pair
// _flash_bwd_dq_kernel / _flash_bwd_dkv_kernel.  Their split followed VMEM
// sizes and the TPU's sequential grid; here one design serves every length.
//
// What it computes: the FlashAttention-2 backward of K1 (flash_fwd.cu) from
// the log-sum-exp K1 saved, with the mask rebuilt per tile from the same int
// vectors (query i sees key j iff kv_grp[j] <= q_grp[i] && kv_valid[j] &&
// q_seg[i] == kv_seg[j]):
//   P   = exp(S - lse) where allowed, else 0,   S = q~ k^T  (q~ pre-scaled)
//   dV += P^T dO        dP = dO V^T        dS = P * (dP - delta)
//   dK += dS^T q~       dQ = scale * dS K
// with delta = rowsum(dO * O) computed by the caller.  dK and dV are summed
// over the query heads of a GQA group in fp32 registers, so no per-query-head
// buffer exists.  Rows that see no key get P = 0 (their lse is ~MASKED_BIAS,
// so exp is only evaluated under the mask's select, never multiplied by it).
//
// What bounds it on the card: like the forward, about 8*S^2*D flops per
// (b, h) over 8*S*D bytes, so the tensor cores; the design keeps every
// product on mma.sync with operands fetched by ldmatrix.
// Design: two launches on the caller's stream, both deterministic (no
// atomics):
//  * dkv_kernel, one block of 4 warps per (64-row kv tile, kv head, b).  K and
//    V of the tile stay in shared memory; each warp owns 16 kv rows and keeps
//    their dK and dV accumulators in registers.  The block lists the 32-row q
//    tiles that reach its kv tile (a q tile whose largest q_grp is below the
//    tile's smallest valid kv_grp is skipped, the backward image of K1's
//    causal skip) and streams (query head, q tile) items through two cp.async
//    buffers: q~, dO, lse, delta and the q mask vectors of the next item load
//    while this one computes S^T = K q~^T, P^T, dV += P^T dO, dP^T = V dO^T,
//    dS^T and dK += dS^T q~.
//  * dq_kernel, one block per (64-row q tile, q head, b), the forward's
//    shape: it lists the live kv tiles as K1 does and streams K and V through
//    two buffers, recomputing S and dP to accumulate dQ += dS K in registers.
// The second launch recomputes S and dP; in exchange dq is written once,
// deterministically, with no fp32 workspace.
// Precision: P and dS enter their products (dV += P^T dO, dK += dS^T q~,
// dQ += dS K) as two bf16 parts each, hi = bf16(x) and lo = bf16(x - hi), one
// product per part, so they keep about 16 bits as the JAX kernels' fp32 P and
// dS do.  Rounded once to bf16, they left the gradients up to ~3x the plain
// version's error: each row of dS sums to zero, so dQ = dS K cancels.  That
// makes 10 products per tile pair (6 in dkv_kernel, 4 in dq_kernel).  wgmma,
// TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int BKV = 64;        // kv rows per dkv block and per dq-kernel kv tile
constexpr int BQD = 32;        // q rows per dkv-kernel item
constexpr int BQ = 64;         // q rows per dq block
constexpr int MAX_KV_TILES = 256;  // Skv <= 16384, as K1
constexpr int MAX_Q_TILES = 512;   // Sq <= 16384 in 32-row tiles

template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8;  // padded rows: conflict-free ldmatrix
  __nv_bfloat16 k[BKV][LD];
  __nv_bfloat16 v[BKV][LD];
  __nv_bfloat16 q[2][BQD][LD];
  __nv_bfloat16 dO[2][BQD][LD];
  float lse[2][BQD], delta[2][BQD];
  int qg[2][BQD], qs[2][BQD];
  int qmax[MAX_Q_TILES];  // largest q_grp per 32-row q tile
  short live[MAX_Q_TILES];
  int kvmin, nlive;
};

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  __nv_bfloat16 q[BQ][LD];
  __nv_bfloat16 dO[BQ][LD];
  __nv_bfloat16 k[2][BKV][LD];
  __nv_bfloat16 v[2][BKV][LD];
  int kg[2][BKV], kvld[2][BKV], ks[2][BKV];
  int tmin[MAX_KV_TILES];  // smallest valid kv_grp per kv tile
  short live[MAX_KV_TILES];
  int qmax, nlive;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of `bytes` (16 or 0) from global, the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of a 16x16 product operand from registers holding two adjacent
// 16x8 accumulator tiles (the score layout of mma16816)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The same fragment split in two, hi = bf16(x) and lo = bf16(x - hi), so that
// hi * B + lo * B carries x to about 16 bits
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1, uint32_t hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&l)[4], const float (&h)[4]) {
  acc_to_a(hi, l, h);
  lo[0] = pack_bf16_rest(l[0], l[1], hi[0]);
  lo[1] = pack_bf16_rest(l[2], l[3], hi[1]);
  lo[2] = pack_bf16_rest(h[0], h[1], hi[2]);
  lo[3] = pack_bf16_rest(h[2], h[3], hi[3]);
}

// Rows [row0, row0 + ROWS) of a [B, S, H, D] bf16 tensor, head h, into a
// padded shared tile; rows past S read as zeros.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[LD], const __nv_bfloat16* src,
                                          int b, int row0, int S, int H, int h, int tid) {
  constexpr int V8 = D / 8;
  for (int idx = tid; idx < ROWS * V8; idx += NTHREADS) {
    const int r = idx / V8, c = (idx % V8) * 8, i = row0 + r;
    const size_t off = ((size_t(b) * S + min(i, S - 1)) * H + h) * D + c;
    cp_async16(&dst[r][c], src + off, i < S ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (kv tile, kv head, b)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);
  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, g = lane >> 2, t4 = lane & 3;
  const int nqt = (Sq + BQD - 1) / BQD;
  const int* qgb = q_grp + size_t(b) * Sq;
  const int* qsb = q_seg ? q_seg + size_t(b) * Sq : nullptr;

  // ---- K, V of the tile; this thread's two kv rows' mask values ----
  load_rows<D, BKV>(sm.k, k, b, k0, Skv, Hkv, hk, tid);
  load_rows<D, BKV>(sm.v, v, b, k0, Skv, Hkv, hk, tid);
  cp_async_commit();
  int kg_r[2], kvv_r[2], ks_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = k0 + r0 + g + 8 * rr;
    const bool in = j < Skv;
    kvv_r[rr] = in ? kv_valid[size_t(b) * Skv + j] : 0;
    kg_r[rr] = in ? kv_grp[size_t(b) * Skv + j] : INT_MAX;
    ks_r[rr] = (in && kv_seg) ? kv_seg[size_t(b) * Skv + j] : 0;
  }

  // ---- the q tiles that reach this kv tile ----
  if (tid == 0) sm.kvmin = INT_MAX;
  for (int t = warp; t < nqt; t += NTHREADS / 32) {  // one warp per 32-row q tile
    const int i = t * BQD + lane;
    int mx = i < Sq ? qgb[i] : INT_MIN;
    for (int off = 16; off; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) sm.qmax[t] = mx;
  }
  __syncthreads();
  if (tid < BKV) {
    const int j = k0 + tid;
    if (j < Skv && kv_valid[size_t(b) * Skv + j]) atomicMin(&sm.kvmin, kv_grp[size_t(b) * Skv + j]);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < nqt; ++t)
      if (sm.kvmin != INT_MAX && sm.qmax[t] >= sm.kvmin) sm.live[n++] = static_cast<short>(t);
    sm.nlive = n;
  }
  __syncthreads();
  const int nlive = sm.nlive, nitems = nlive * group;

  // item n -> (query head hk * group + n / nlive, q tile live[n % nlive])
  auto load_item = [&](int n, int buf) {
    const int h = hk * group + n / nlive, i0 = sm.live[n % nlive] * BQD;
    load_rows<D, BQD>(sm.q[buf], q, b, i0, Sq, Hq, h, tid);
    load_rows<D, BQD>(sm.dO[buf], dout, b, i0, Sq, Hq, h, tid);
    if (tid < BQD) {
      const int i = min(i0 + tid, Sq - 1), in = i0 + tid < Sq ? 4 : 0;
      const size_t row = (size_t(b) * Hq + h) * Sq + i;
      cp_async4(&sm.lse[buf][tid], lse + row, in);
      cp_async4(&sm.delta[buf][tid], delta + row, in);
      cp_async4(&sm.qg[buf][tid], qgb + i, in);
      if (qsb) cp_async4(&sm.qs[buf][tid], qsb + i, in);
      else sm.qs[buf][tid] = 0;
    }
    cp_async_commit();
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (nitems > 0) load_item(0, 0);
  for (int it = 0; it < nitems; ++it) {
    const int buf = it & 1;
    if (it + 1 < nitems) {
      load_item(it + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n");
    } else {
      asm volatile("cp.async.wait_group 0;\n");
    }
    __syncthreads();
    const int i0 = sm.live[it % nlive] * BQD;

    // ---- S^T = K q~^T (16 kv rows x 32 q columns per warp) and dP^T = V dO^T ----
    float s[BQD / 8][4], dp[BQD / 8][4];
#pragma unroll
    for (int j = 0; j < BQD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, &sm.k[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      ldsm_x4(va, &sm.v[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int jp = 0; jp < BQD / 16; ++jp) {
        const int row = jp * 16 + (lane >> 4) * 8 + (lane & 7), col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, &sm.q[buf][row][col]);
        ldsm_x4(bo, &sm.dO[buf][row][col]);
        mma16816(s[2 * jp], ka, bq[0], bq[1]);
        mma16816(s[2 * jp + 1], ka, bq[2], bq[3]);
        mma16816(dp[2 * jp], va, bo[0], bo[1]);
        mma16816(dp[2 * jp + 1], va, bo[2], bo[3]);
      }
    }

    // ---- P^T (fp32, masked before exp can overflow) and dS^T = P^T (dP^T - delta) ----
#pragma unroll
    for (int j = 0; j < BQD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
        const bool ok = i0 + c < Sq && kvv_r[rr] && kg_r[rr] <= sm.qg[buf][c] &&
                        ks_r[rr] == sm.qs[buf][c];
        const float p = ok ? __expf(s[j][e] - sm.lse[buf][c]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sm.delta[buf][c]);
      }
    }

    // ---- dV += P^T dO and dK += dS^T q~ (A operands straight from registers) ----
#pragma unroll
    for (int kk = 0; kk < BQD / 16; ++kk) {
      uint32_t pa[4], pr[4], da[4], dr[4];
      acc_to_a_split(pa, pr, s[2 * kk], s[2 * kk + 1]);
      acc_to_a_split(da, dr, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7), col = np * 16 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, &sm.dO[buf][row][col]);
        ldsm_x4_t(bq, &sm.q[buf][row][col]);
        mma16816(dv_acc[2 * np], pa, bo[0], bo[1]);
        mma16816(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
        mma16816(dv_acc[2 * np], pr, bo[0], bo[1]);
        mma16816(dv_acc[2 * np + 1], pr, bo[2], bo[3]);
        mma16816(dk_acc[2 * np], da, bq[0], bq[1]);
        mma16816(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        mma16816(dk_acc[2 * np], dr, bq[0], bq[1]);
        mma16816(dk_acc[2 * np + 1], dr, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is refilled next
  }
  asm volatile("cp.async.wait_group 0;\n");  // the K/V group when no q tile was live

  // ---- dK (already w.r.t. the scaled q~, so the scale is folded in) and dV ----
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = k0 + r0 + g + 8 * rr;
    if (j >= Skv) continue;
    const size_t off = ((size_t(b) * Skv + j) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t4) =
          pack_bf16(dk_acc[n][2 * rr], dk_acc[n][2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t4) =
          pack_bf16(dv_acc[n][2 * rr], dv_acc[n][2 * rr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, q head, b)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_grp, const int* __restrict__ kv_grp,
    const int* __restrict__ kv_valid, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
    int Hq, int Hkv, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, g = lane >> 2, t4 = lane & 3;
  const int ntiles = (Skv + BKV - 1) / BKV;
  const int* kvg = kv_grp + size_t(b) * Skv;
  const int* kvv = kv_valid + size_t(b) * Skv;
  const int* kvs = kv_seg ? kv_seg + size_t(b) * Skv : nullptr;

  load_rows<D, BQ>(sm.q, q, b, q0, Sq, Hq, h, tid);
  load_rows<D, BQ>(sm.dO, dout, b, q0, Sq, Hq, h, tid);
  cp_async_commit();

  // this thread's two query rows: mask values, lse, delta (padded rows see nothing)
  int qg_r[2], qs_r[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + r0 + g + 8 * rr;
    const bool in = i < Sq;
    qg_r[rr] = in ? q_grp[size_t(b) * Sq + i] : INT_MIN;
    qs_r[rr] = (in && q_seg) ? q_seg[size_t(b) * Sq + i] : 0;
    lse_r[rr] = in ? lse[(size_t(b) * Hq + h) * Sq + i] : 0.f;
    delta_r[rr] = in ? delta[(size_t(b) * Hq + h) * Sq + i] : 0.f;
  }

  // ---- the live kv tiles, as K1 lists them ----
  if (tid == 0) sm.qmax = INT_MIN;
  for (int t = tid; t < ntiles; t += NTHREADS) sm.tmin[t] = INT_MAX;
  __syncthreads();
  if (tid < BQ && q0 + tid < Sq) atomicMax(&sm.qmax, q_grp[size_t(b) * Sq + q0 + tid]);
  for (int j = tid; j < Skv; j += NTHREADS)
    if (kvv[j]) atomicMin(&sm.tmin[j / BKV], kvg[j]);
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < ntiles; ++t)
      if (sm.tmin[t] <= sm.qmax) sm.live[n++] = static_cast<short>(t);
    sm.nlive = n;
  }
  __syncthreads();
  const int nlive = sm.nlive;

  auto load_tile = [&](int t, int buf) {
    const int j0 = t * BKV;
    load_rows<D, BKV>(sm.k[buf], k, b, j0, Skv, Hkv, hk, tid);
    load_rows<D, BKV>(sm.v[buf], v, b, j0, Skv, Hkv, hk, tid);
    if (tid < BKV) {
      const int j = min(j0 + tid, Skv - 1), in = j0 + tid < Skv ? 4 : 0;
      cp_async4(&sm.kg[buf][tid], kvg + j, in);
      cp_async4(&sm.kvld[buf][tid], kvv + j, in);
      if (kvs) cp_async4(&sm.ks[buf][tid], kvs + j, in);
      else sm.ks[buf][tid] = 0;
    }
    cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (nlive > 0) load_tile(sm.live[0], 0);
  for (int it = 0; it < nlive; ++it) {
    const int buf = it & 1;
    if (it + 1 < nlive) {
      load_tile(sm.live[it + 1], buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n");
    } else {
      asm volatile("cp.async.wait_group 0;\n");
    }
    __syncthreads();

    // ---- S = q~ K^T and dP = dO V^T, 16 x 64 per warp ----
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, &sm.q[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      ldsm_x4(oa, &sm.dO[r0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        const int row = jp * 16 + (lane >> 4) * 8 + (lane & 7), col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, &sm.k[buf][row][col]);
        ldsm_x4(bv, &sm.v[buf][row][col]);
        mma16816(s[2 * jp], qa, bk[0], bk[1]);
        mma16816(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma16816(dp[2 * jp], oa, bv[0], bv[1]);
        mma16816(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }

    // ---- dS = P (dP - delta), P masked before exp can overflow ----
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, c = j * 8 + 2 * t4 + (e & 1);
        const bool ok = sm.kvld[buf][c] && sm.kg[buf][c] <= qg_r[rr] && sm.ks[buf][c] == qs_r[rr];
        const float p = ok ? __expf(s[j][e] - lse_r[rr]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[rr]);
      }
    }

    // ---- dQ += dS K ----
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t da[4], dr[4];
      acc_to_a_split(da, dr, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, &sm.k[buf][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)][np * 16 + (lane >> 4) * 8]);
        mma16816(acc[2 * np], da, bk[0], bk[1]);
        mma16816(acc[2 * np + 1], da, bk[2], bk[3]);
        mma16816(acc[2 * np], dr, bk[0], bk[1]);
        mma16816(acc[2 * np + 1], dr, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is refilled next
  }
  asm volatile("cp.async.wait_group 0;\n");  // the q/dO group when no tile was live

  // ---- dq = scale * acc (the products were taken w.r.t. the scaled q~) ----
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + r0 + g + 8 * rr;
    if (i >= Sq) continue;
    __nv_bfloat16* row = dq + ((size_t(b) * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * rr] * scale, acc[n][2 * rr + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, const int* q_grp, const int* kv_grp,
                   const int* kv_valid, const int* q_seg, const int* kv_seg, void* dq,
                   void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv, float scale,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int smem_kv = sizeof(DkvSmem<D>), smem_q = sizeof(DqSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* op = static_cast<const bf*>(dout);
  dkv_kernel<D><<<dim3((Skv + BKV - 1) / BKV, Hkv, B), NTHREADS, smem_kv, stream>>>(
      qp, kp, vp, op, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, static_cast<bf*>(dk),
      static_cast<bf*>(dv), Sq, Skv, Hq, Hkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3((Sq + BQ - 1) / BQ, Hq, B), NTHREADS, smem_q, stream>>>(
      qp, kp, vp, op, lse, delta, q_grp, kv_grp, kv_valid, q_seg, kv_seg, static_cast<bf*>(dq),
      Sq, Skv, Hq, Hkv, scale);
  return cudaGetLastError();
}

}  // namespace

// q is the pre-scaled q~ = bf16(q * scale); lse and delta are fp32 [B, Hq, Sq].
extern "C" int dbx_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* q_grp,
                             const void* kv_grp, const void* kv_valid, const void* q_seg,
                             const void* kv_seg, void* dq, void* dk, void* dv, int B, int Sq,
                             int Skv, int Hq, int Hkv, int D, float scale, void* stream) {
  if (Skv < 1 || Skv > MAX_KV_TILES * BKV || Sq < 1 || Sq > MAX_Q_TILES * BQD || Hkv < 1 ||
      Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse), dl = static_cast<const float*>(delta);
  auto qg = static_cast<const int*>(q_grp), kg = static_cast<const int*>(kv_grp);
  auto kvv = static_cast<const int*>(kv_valid);
  auto qs = static_cast<const int*>(q_seg), ks = static_cast<const int*>(kv_seg);
  if (D == 128)
    return launch<128>(q, k, v, dout, l, dl, qg, kg, kvv, qs, ks, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                       scale, st);
  if (D == 64)
    return launch<64>(q, k, v, dout, l, dl, qg, kg, kvv, qs, ks, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                      scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
