// K2: the whole DiT diffusion sampling loop (DDIM or DPM-Solver++(2M), with
// or without classifier-free guidance) in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel dexbotic_tpu/ops/dit_fused.py:_kernel, whose
// (step, layer) grid ran in order on one core while Pallas prefetched layer
// j+1's weights.  Per step: embed x and prepend the precomputed condition
// token; per layer: non-affine LayerNorm (eps 1e-6) -> qkv -> per-head
// attention inside each CFG row group -> o-proj + residual -> LayerNorm ->
// GELU-tanh MLP + residual; after the last layer: final LayerNorm and
// projection, CFG combine, scheduler update from a coefficient table.
//
// What bounds it on the card: at serving batch (2-4 rows of 17 tokens) every
// product is a skinny [<=80, K] x [K, N] one, so the work is streaming the
// DiT-B weights (~14 MB bf16 per layer, ~170 MB per step, more than the 50 MB
// L2) plus the latency of ~110 dependent phases per step.  Launched as eager
// PyTorch ops, each phase is a separate kernel and the loop is launch-bound.
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, one
// block per SM, the occupancy calculator checking that it fits) that walks
// every (step, layer, phase) itself and separates phases with
// cooperative_groups grid.sync(), about 1.2 us each on an H100.  A product
// phase is cut into (128-deep k chunk, 128-column block) items spread evenly
// over all blocks.  Weights do not depend on activations, so each block
// requests its next product's 32 KB weight slabs (whole 256-byte rows) with
// cp.async one phase ahead, as the TPU kernel prefetched layer j + 1; inside
// the product only the activation slab (L2-resident) is loaded.  Each of the
// 8 warps then runs the ldmatrix + mma.sync m16n8k16 steps (bf16 in, fp32
// accumulation) of one 16-column fragment, loading step k + 1's fragments
// while step k multiplies, and stores its fp32 partial product straight to
// global scratch.  No block waits on another inside a phase: the next phase
// sums an element's partials in chunk order (a bias phase for qkv, a bias +
// GELU phase for fc0, a residual + LayerNorm phase for o-proj and fc1), so
// the result does not depend on timing.  What bounds it now: the tensor-core
// issue of one item (48 padded rows at B=1) and the ~1 us latency of each
// phase's loads.  Activations (<= 80 x 3072) live in global scratch that the
// wrapper allocates; their padded rows stay zero.
// Numerics follow the TPU kernel: products accumulate in fp32 and round to
// the weight dtype, LayerNorm/softmax/scheduler math is fp32, the residual
// stream is kept in the weight dtype.  The fp32-weight instance uses plain
// FMA instead of tensor cores.
// Int8 block weights (the JAX int8 path, dit_fused.py:84-88): each layer's
// q [N, K] int8 (a column's k contiguous) with per-column scales s [N] in the
// weight dtype.  cp.async lands the int8 slab where the dense slab would go,
// half the bytes of the bf16 stream; the product builds each mma B fragment
// from two int8 of one column, each dequantized to the weight dtype as
// round(float(q) * float(s)), the TPU kernel's `w.astype(cdtype) *
// s.astype(cdtype)`, and then multiplies exactly as the dense path does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;  // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int RFMAX = 5;  // row fragments: rows * (chunk + 1) <= 80
constexpr int RPMAX = RFMAX * 16;
constexpr int AMAX = 16;  // action dim
constexpr int KC = 128;  // k depth of a product item
constexpr int NC = NW * 16;  // columns of a product item: one 16-column fragment per warp
constexpr float LN_EPS = 1e-6f;

// Shared-memory slabs of one product item, rows padded by 16 bytes so the
// ldmatrix rows hit distinct banks: activations [RPMAX, KC], weights [KC, NC].
// Two items per block: ~111 KB for bf16, ~215 KB for fp32.
template <typename T>
struct Stage {
  static_assert(KC == NC, "one padded row length serves both slabs");
  static constexpr int LD = KC + 16 / int(sizeof(T));
  static constexpr int A_ELEMS = RPMAX * LD;
  static constexpr int ELEMS = A_ELEMS + KC * LD;
  static constexpr int BYTES = 2 * ELEMS * int(sizeof(T));
};

// An int8 weight slab [NC columns][KC k] takes the dense slab's place; its
// rows are padded by 16 bytes so a warp's fragment loads hit distinct banks.
constexpr int LDQ = KC + 16;
static_assert(NC * LDQ <= KC * Stage<__nv_bfloat16>::LD * 2, "int8 slab fits the weight slab");

struct Params {
  const float* coef;  // [N, 6] scheduler coefficients, execution order
  const void* cond;   // [N, rows, H] condition token per step
  const float* x0;    // [B, T, A] initial noise
  const void* pos;    // [S, H]
  const void* xw;     // [A, H]
  const float* xb;    // [H]
  const void* fw;     // [H, A]
  const float* fb;    // [A]
  const void* wqkv;   // [depth, H, 3H] (int8: [depth, 3H, H])
  const void* sqkv;   // int8 only: [depth, 3H] scales in the weight dtype
  const float* bqkv;  // [depth, 3H]
  const void* wo;     // [depth, H, H]
  const void* so;
  const float* bo;
  const void* w0;  // [depth, H, M] (int8: [depth, M, H])
  const void* s0;
  const float* b0;
  const void* w1;  // [depth, M, H] (int8: [depth, H, M])
  const void* s1;
  const float* b1;
  float* out;  // [B, T, A]
  void* h;     // [RP, H] residual stream
  void* hn;    // [RP, H] LayerNorm output
  void* qkv;   // [RP, 3H]
  void* attn;  // [RP, H]
  void* m;     // [RP, M]
  float* x;    // [B, T, A] current sample
  float* xp;   // [B, T, A] DPM x0 of the previous step
  float* part;  // [K / KC, RP, N] partial products of the last product phase
  int B, T, A, H, heads, M, depth, N, RP, cfg_pair;
  float cfg_scale;
  int sampler;  // 0 ddim, 1 dpm
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// round through the weight dtype, as `.astype(cdtype)` does
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// sum over the block, the same fixed order in every block; `sh` holds NW floats
__device__ __forceinline__ float block_sum(float x, float* sh) {
  x = warp_sum(x);
  __syncthreads();  // `sh` may still be read from the previous call
  if (threadIdx.x % 32 == 0) sh[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += sh[w];
  return s;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


__device__ __forceinline__ int num_rows(const Params& p) { return (p.cfg_pair ? 2 : 1) * p.B * (p.T + 1); }

// the product of row r, column n: its partials summed in chunk order
__device__ __forceinline__ float part_sum(const Params& p, int nc, int N, int r, int n) {
  float s = 0.f;
  for (int c = 0; c < nc; ++c) s += __ldcg(p.part + (size_t(c) * p.RP + r) * N + n);
  return s;
}

// ---- x embed + condition token + position embedding -> h ----
template <typename T>
__device__ void embed_phase(const Params& p, int step) {
  const int S = p.T + 1, rows = (p.cfg_pair ? 2 : 1) * p.B, R = rows * S;
  const T* cond = static_cast<const T*>(p.cond) + size_t(step) * rows * p.H;
  const T* pos = static_cast<const T*>(p.pos);
  const T* xw = static_cast<const T*>(p.xw);
  T* h = static_cast<T*>(p.h);
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < R * p.H; e += gridDim.x * NTHREADS) {
    const int r = e / p.H, n = e % p.H, g = r / S, s = r % S;
    float val;
    if (s == 0) {
      val = to_f<T>(cond[g * p.H + n]);
    } else {
      const float* xr = p.x + ((g % p.B) * p.T + (s - 1)) * p.A;  // CFG halves share x
      float acc = 0.f;
      for (int a = 0; a < p.A; ++a) acc += rnd<T>(xr[a]) * to_f<T>(xw[a * p.H + n]);
      val = rnd<T>(rnd<T>(acc) + rnd<T>(p.xb[n]));
    }
    h[e] = from_f<T>(val + to_f<T>(pos[s * p.H + n]));
  }
}

// ---- one block per row: h += rnd(partials + bias) (when nc > 0), hn = LN(h) ----
template <typename T>
__device__ void residual_ln_phase(const Params& p, const float* __restrict__ bias, int nc, float* sm) {
  T* h = static_cast<T*>(p.h);
  T* hn = static_cast<T*>(p.hn);
  float* row = sm;  // [H]
  float* sh = sm + p.H;  // [NW]
  for (int r = blockIdx.x; r < num_rows(p); r += gridDim.x) {
    float s = 0.f;
    for (int n = threadIdx.x; n < p.H; n += NTHREADS) {
      float v = to_f<T>(h[size_t(r) * p.H + n]);
      if (nc > 0) {
        v = to_f<T>(from_f<T>(rnd<T>(part_sum(p, nc, p.H, r, n) + bias[n]) + v));
        h[size_t(r) * p.H + n] = from_f<T>(v);
      }
      row[n] = v;
      s += v;
    }
    const float mean = block_sum(s, sh) / p.H;
    float v = 0.f;
    for (int n = threadIdx.x; n < p.H; n += NTHREADS) {
      const float d = row[n] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(block_sum(v, sh) / p.H + LN_EPS);
    for (int n = threadIdx.x; n < p.H; n += NTHREADS)
      hn[size_t(r) * p.H + n] = from_f<T>((row[n] - mean) * rstd);
    __syncthreads();  // `row` is refilled for the next row
  }
}

// ---- out[R, N] = act(rnd(partials of a K = H product + bias)), act = GELU-tanh or none ----
template <typename T, bool GELU>
__device__ void bias_act_phase(const Params& p, const float* __restrict__ bias, int N, void* out) {
  T* o = static_cast<T*>(out);
  const int nc = p.H / KC;
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < num_rows(p) * N; e += gridDim.x * NTHREADS) {
    const float y = rnd<T>(part_sum(p, nc, N, e / N, e % N) + bias[e % N]);
    o[e] = from_f<T>(GELU ? gelu_tanh(y) : y);
  }
}

// ---- the product phases ----
// part[c] = A[:, c-th k chunk] @ W[c-th k chunk, :] for every chunk c.
// Item i = (chunk i / (N / NC), column block i % (N / NC)); block b takes
// items [b * total / G, (b + 1) * total / G).
template <typename T, bool Q>
struct Product {
  using WT = typename std::conditional<Q, int8_t, T>::type;
  const WT* W;  // [K, N] (int8: [N, K]); null: no product
  const T* S;   // int8 only: the layer's [N] scales
  int K, N;
};

template <typename T, bool Q>
__device__ __forceinline__ void item_range(const Product<T, Q>& pr, int& first, int& last) {
  const int total = (pr.K / KC) * (pr.N / NC), G = gridDim.x;
  first = int(long(blockIdx.x) * total / G);
  last = int(long(blockIdx.x + 1) * total / G);
}

// the item's weight slab [KC, NC] -> Ws (cp.async, whole 16-byte pieces of rows);
// int8: [NC, KC] bytes at row stride LDQ
template <typename T, bool Q>
__device__ __forceinline__ void stage_weights(const Product<T, Q>& pr, int item, T* Ws) {
  const int nblk = pr.N / NC, k0 = (item / nblk) * KC, n0 = (item % nblk) * NC;
  if constexpr (Q) {
    int8_t* Wq = reinterpret_cast<int8_t*>(Ws);
    constexpr int RV = KC / 16;
    for (int e = threadIdx.x; e < NC * RV; e += NTHREADS) {
      const int r = e / RV, v = e % RV;
      cp_async16(Wq + r * LDQ + v * 16, pr.W + size_t(n0 + r) * pr.K + k0 + v * 16);
    }
  } else {
    constexpr int EPV = 16 / int(sizeof(T)), RV = KC / EPV;
    for (int e = threadIdx.x; e < KC * RV; e += NTHREADS) {
      const int r = e / RV, v = e % RV;
      cp_async16(Ws + r * Stage<T>::LD + v * EPV, pr.W + size_t(k0 + r) * pr.N + n0 + v * EPV);
    }
  }
}

// the item's activation slab [RP, KC] -> As
template <typename T, bool Q>
__device__ __forceinline__ void stage_acts(const Params& p, const T* A, const Product<T, Q>& pr,
                                           int item, T* As) {
  constexpr int EPV = 16 / int(sizeof(T)), RV = KC / EPV;
  const int k0 = (item / (pr.N / NC)) * KC;
  for (int e = threadIdx.x; e < p.RP * RV; e += NTHREADS) {
    const int r = e / RV, v = e % RV;
    cp_async16(As + r * Stage<T>::LD + v * EPV, A + size_t(r) * pr.K + k0 + v * EPV);
  }
}

// Request the weight slabs of this block's first two items of `next` into the
// two stages.  Weights do not depend on activations, so they stream in
// during the phase and barriers before their product (the TPU kernel's
// prefetch of layer j + 1, one product ahead); each is issued at the start of
// the non-product phase that follows the previous product.  Those phases only
// use the first stage's activation area, so the requests never collide.
template <typename T, bool Q>
__device__ void prefetch_weights(const Product<T, Q>& next, T* stage) {
  if (next.W == nullptr) return;
  int first, last;
  item_range(next, first, last);
  for (int i = 0; i < 2 && first + i < last; ++i)
    stage_weights(next, first + i, stage + i * Stage<T>::ELEMS + Stage<T>::A_ELEMS);
  cp_async_commit();
}

// The product `cur` of activations A [RP, cur.K]; the weights of its first
// two items were requested by prefetch_weights.
template <typename T, bool Q>
__device__ void gemm_phase(const Params& p, const T* __restrict__ A, const Product<T, Q>& cur, T* stage) {
  using St = Stage<T>;
  const int N = cur.N, nblk = N / NC, RP = p.RP, RF = RP / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int first, last;
  item_range(cur, first, last);
  for (int i = 0; i < 2 && first + i < last; ++i) stage_acts(p, A, cur, first + i, stage + i * St::ELEMS);
  cp_async_commit();
  for (int item = first; item < last; ++item) {
    T* As = stage + ((item - first) & 1) * St::ELEMS;
    cp_async_wait<0>();
    __syncthreads();
    const T* Ws = As + St::A_ELEMS + warp * 16;  // this warp's 16 columns
    // int8: the rows of this warp's 16 columns, and their first column's scale
    const int8_t* Wq = reinterpret_cast<const int8_t*>(As + St::A_ELEMS) + warp * 16 * LDQ;
    const T* S = Q ? cur.S + (item % nblk) * NC + warp * 16 : nullptr;
    float* dst = p.part + size_t(item / nblk) * RP * N + (item % nblk) * NC + warp * 16;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // rows g, g + 8 of each 16-row fragment; columns 2 t4, 2 t4 + 1 of each 8-column half
      const int g = lane >> 2, t4 = lane & 3;
      const T* bsrc = Ws + (((lane >> 3) & 1) * 8 + (lane & 7)) * St::LD + (lane >> 4) * 8;
      const T* asrc = As + (lane & 15) * St::LD + (lane >> 4) * 8;
      float acc[RFMAX][2][4] = {};
      // int8: column g of each 8-column half, k pairs (2 t4, 2 t4 + 1) and (+8, +9)
      float sc[2] = {0.f, 0.f};
      if constexpr (Q) {
        sc[0] = to_f<T>(S[g]);
        sc[1] = to_f<T>(S[8 + g]);
      }
      const int8_t* qsrc = Wq + g * LDQ + 2 * t4;
      auto deq2 = [](const int8_t* src, float scale) {
        const uint16_t v = *reinterpret_cast<const uint16_t*>(src);
        return pack_bf16(float(int8_t(v & 0xff)) * scale, float(int8_t(v >> 8)) * scale);
      };
      // fragments of k step ks + 1 load while step ks multiplies: one item is
      // only 8 steps, too short for the warp scheduler to hide the latencies
      uint32_t bw[2][4], af[2][RFMAX][4];
      auto load = [&](int ks, int buf) {
        if constexpr (Q) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int8_t* src = qsrc + hf * 8 * LDQ + ks * 16;
            bw[buf][2 * hf] = deq2(src, sc[hf]);
            bw[buf][2 * hf + 1] = deq2(src + 8, sc[hf]);
          }
        } else {
          ldsm_x4_t(bw[buf], bsrc + ks * 16 * St::LD);  // W[k:k+16, 16 columns] as two col-major 16x8
        }
#pragma unroll
        for (int rf = 0; rf < RFMAX; ++rf)
          if (rf < RF) ldsm_x4(af[buf][rf], asrc + rf * 16 * St::LD + ks * 16);
      };
      load(0, 0);
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        if (ks + 1 < KC / 16) load(ks + 1, (ks + 1) & 1);
#pragma unroll
        for (int rf = 0; rf < RFMAX; ++rf) {
          if (rf < RF) {
            mma16816(acc[rf][0], af[ks & 1][rf], bw[ks & 1][0], bw[ks & 1][1]);
            mma16816(acc[rf][1], af[ks & 1][rf], bw[ks & 1][2], bw[ks & 1][3]);
          }
        }
      }
#pragma unroll
      for (int rf = 0; rf < RFMAX; ++rf) {
        if (rf < RF) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float* d = dst + size_t(rf * 16 + g) * N + hf * 8 + 2 * t4;
            *reinterpret_cast<float2*>(d) = make_float2(acc[rf][hf][0], acc[rf][hf][1]);
            *reinterpret_cast<float2*>(d + size_t(8) * N) = make_float2(acc[rf][hf][2], acc[rf][hf][3]);
          }
        }
      }
    } else {
      const int col = lane & 15, half = lane >> 4;
      const float sc = Q ? to_f<T>(S[col]) : 0.f;
      float acc[RFMAX][8] = {};
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        const float w = Q ? rnd<T>(float(Wq[col * LDQ + k]) * sc) : to_f<T>(Ws[k * St::LD + col]);
#pragma unroll
        for (int rf = 0; rf < RFMAX; ++rf)
          if (rf < RF)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              acc[rf][i] += to_f<T>(As[(rf * 16 + half * 8 + i) * St::LD + k]) * w;
      }
#pragma unroll
      for (int rf = 0; rf < RFMAX; ++rf)
        if (rf < RF)
#pragma unroll
          for (int i = 0; i < 8; ++i) dst[size_t(rf * 16 + half * 8 + i) * N + col] = acc[rf][i];
    }
    __syncthreads();  // this stage is refilled next
    if (item + 2 < last) {  // more than two items: load the third into the freed stage
      stage_weights(cur, item + 2, As + St::A_ELEMS);
      stage_acts(p, A, cur, item + 2, As);
      cp_async_commit();
    }
  }
}

// ---- per-(row group, head) attention over the S tokens of one group ----
// One block per unit: q (pre-scaled), k, v of the unit go to shared memory
// in fp32 (k rows padded by one word against bank conflicts), then the
// warps split the queries.
template <typename T>
__device__ void attn_phase(const Params& p, float* sm) {
  const int S = p.T + 1, rows = (p.cfg_pair ? 2 : 1) * p.B, dh = p.H / p.heads;
  const int H3 = 3 * p.H, warp = threadIdx.x / 32, lane = threadIdx.x % 32, kd = dh + 1;
  const float scale = 1.f / sqrtf(float(dh));
  const T* qkv = static_cast<const T*>(p.qkv);
  T* attn = static_cast<T*>(p.attn);
  float* qs = sm;
  float* ks = qs + S * dh;
  float* vs = ks + S * kd;
  for (int u = blockIdx.x; u < rows * p.heads; u += gridDim.x) {
    const int g = u / p.heads, hh = u % p.heads;
    const T* base = qkv + size_t(g) * S * H3 + hh * dh;
    for (int e = threadIdx.x; e < S * dh; e += NTHREADS) {
      const int i = e / dh, c = e % dh;
      qs[e] = to_f<T>(base[i * H3 + c]) * scale;
      ks[i * kd + c] = to_f<T>(base[i * H3 + p.H + c]);
      vs[e] = to_f<T>(base[i * H3 + 2 * p.H + c]);
    }
    __syncthreads();
    for (int i = warp; i < S; i += NW) {
      float s = -INFINITY;
      if (lane < S) {
        float d = 0.f;
        for (int c = 0; c < dh; ++c) d += qs[i * dh + c] * ks[lane * kd + c];
        s = d;
      }
      const float mx = warp_max(s);
      const float e = lane < S ? expf(s - mx) : 0.f;
      const float pr = e / warp_sum(e);
      for (int c0 = 0; c0 < dh; c0 += 32) {  // every lane runs every shuffle
        const int c = c0 + lane;
        float acc = 0.f;
        for (int j = 0; j < S; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pr, j);
          if (c < dh) acc += pj * vs[j * dh + c];
        }
        if (c < dh) attn[(size_t(g) * S + i) * p.H + hh * dh + c] = from_f<T>(acc);
      }
    }
    __syncthreads();
  }
}

// ---- final projection of hn (the last layer's LayerNorm), CFG combine,
// scheduler update.  One block per (b, t) output row; the per-thread action
// sums are unrolled over AMAX so they stay in registers.
template <typename T>
__device__ void final_phase(const Params& p, int step, float* sm) {
  const int S = p.T + 1, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int halves = p.cfg_pair ? 2 : 1;
  const T* hn = static_cast<const T*>(p.hn);
  const T* fw = static_cast<const T*>(p.fw);
  const float* c = p.coef + step * 6;
  float* red = sm;  // [NW, 2, AMAX] per-warp sums
  for (int u = blockIdx.x; u < p.B * p.T; u += gridDim.x) {
    const int b = u / p.T, s = u % p.T;
    for (int half = 0; half < halves; ++half) {
      const T* row = hn + (size_t(half * p.B + b) * S + 1 + s) * p.H;  // drop cond token
      float part[AMAX];
#pragma unroll
      for (int a = 0; a < AMAX; ++a) part[a] = 0.f;
      for (int k = threadIdx.x; k < p.H; k += NTHREADS) {
        const float xn = to_f<T>(row[k]);
#pragma unroll
        for (int a = 0; a < AMAX; ++a)
          if (a < p.A) part[a] += xn * to_f<T>(fw[k * p.A + a]);
      }
#pragma unroll
      for (int a = 0; a < AMAX; ++a) {
        if (a < p.A) {
          const float tot = warp_sum(part[a]);
          if (lane == 0) red[(warp * 2 + half) * AMAX + a] = tot;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < p.A) {
      const int a = threadIdx.x;
      float eps[2] = {0.f, 0.f};
      for (int half = 0; half < halves; ++half) {
        for (int w = 0; w < NW; ++w) eps[half] += red[(w * 2 + half) * AMAX + a];
        eps[half] += p.fb[a];
      }
      const float e = p.cfg_pair ? eps[1] + p.cfg_scale * (eps[0] - eps[1]) : eps[0];
      const int idx = (b * p.T + s) * p.A + a;
      const float xv = p.x[idx];
      float xn;
      if (p.sampler == 0) {  // DDIM: x0 = (x - sqrt(1-a) e)/sqrt(a); x' = sqrt(ap) x0 + sqrt(1-ap) e
        xn = (xv - c[1] * e) / c[0] * c[2] + c[3] * e;
      } else {  // DPM-Solver++(2M)
        const float x0 = (xv - c[1] * e) / c[0];
        const float d = (1.f + c[4]) * x0 - c[4] * p.xp[idx];
        xn = c[2] * xv + c[3] * d;
        p.xp[idx] = x0;
      }
      p.x[idx] = xn;
      if (step == p.N - 1) p.out[idx] = xn;
    }
    __syncthreads();  // `red` is refilled for the next row
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(NTHREADS) dit_sample_kernel(Params p) {
  using Pr = Product<T, Q>;
  using WT = typename Pr::WT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  float* sm = reinterpret_cast<float*>(smem);  // the non-product phases' view
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, M = p.M, n = p.B * p.T * p.A;
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < n; e += gridDim.x * NTHREADS) {
    p.x[e] = p.x0[e];
    p.xp[e] = 0.f;
  }
  grid.sync();
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wo = static_cast<const WT*>(p.wo);
  const WT* w0 = static_cast<const WT*>(p.w0);
  const WT* w1 = static_cast<const WT*>(p.w1);
  // int8 scales of layer j (null for dense weights)
  auto scales = [](const void* base, size_t off) {
    return Q ? static_cast<const T*>(base) + off : static_cast<const T*>(nullptr);
  };
  const T* hn = static_cast<const T*>(p.hn);
  const T* attn = static_cast<const T*>(p.attn);
  const T* m = static_cast<const T*>(p.m);
  const Pr qkv0{wqkv, scales(p.sqkv, 0), H, 3 * H}, none{nullptr, nullptr, 0, 0};
  prefetch_weights(qkv0, stage);
  for (int step = 0; step < p.N; ++step) {
    embed_phase<T>(p, step);
    grid.sync();
    residual_ln_phase<T>(p, nullptr, 0, sm);
    grid.sync();
    for (int j = 0; j < p.depth; ++j) {
      const Pr pqkv{wqkv + size_t(j) * H * 3 * H, scales(p.sqkv, size_t(j) * 3 * H), H, 3 * H};
      const Pr po{wo + size_t(j) * H * H, scales(p.so, size_t(j) * H), H, H};
      const Pr p0{w0 + size_t(j) * H * M, scales(p.s0, size_t(j) * M), H, M};
      const Pr p1{w1 + size_t(j) * M * H, scales(p.s1, size_t(j) * H), M, H};
      const Pr after = j + 1 < p.depth
                           ? Pr{pqkv.W + size_t(H) * 3 * H, scales(p.sqkv, size_t(j + 1) * 3 * H), H, 3 * H}
                           : step + 1 < p.N ? qkv0 : none;
      gemm_phase<T, Q>(p, hn, pqkv, stage);
      grid.sync();
      prefetch_weights(po, stage);
      bias_act_phase<T, false>(p, p.bqkv + size_t(j) * 3 * H, 3 * H, p.qkv);
      grid.sync();
      attn_phase<T>(p, sm);
      grid.sync();
      gemm_phase<T, Q>(p, attn, po, stage);
      grid.sync();
      prefetch_weights(p0, stage);
      residual_ln_phase<T>(p, p.bo + size_t(j) * H, H / KC, sm);
      grid.sync();
      gemm_phase<T, Q>(p, hn, p0, stage);
      grid.sync();
      prefetch_weights(p1, stage);
      bias_act_phase<T, true>(p, p.b0 + size_t(j) * M, M, p.m);
      grid.sync();
      gemm_phase<T, Q>(p, m, p1, stage);
      grid.sync();
      prefetch_weights(after, stage);
      residual_ln_phase<T>(p, p.b1 + size_t(j) * H, M / KC, sm);
      grid.sync();
    }
    final_phase<T>(p, step, sm);
    grid.sync();
  }
}

template <typename T, bool Q>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = Stage<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dit_sample_kernel<T, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int occ = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, dit_sample_kernel<T, Q>, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  // One block per SM: the items already spread every product over all SMs,
  // and a grid barrier costs more the more blocks it waits for.
  dim3 grid(sms);
  Params local = p;
  void* args[] = {&local};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dit_sample_kernel<T, Q>), grid,
                                    dim3(NTHREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int dbx_dit_sample(int bf16, int int8, const void* coef, const void* cond,
                              const void* x0, const void* pos, const void* xw, const void* xb,
                              const void* fw, const void* fb, const void* wqkv, const void* sqkv,
                              const void* bqkv, const void* wo, const void* so, const void* bo,
                              const void* w0, const void* s0, const void* b0, const void* w1,
                              const void* s1, const void* b1, void* out, void* h, void* hn, void* qkv,
                              void* attn, void* m, void* x, void* xp, void* part, int B, int T,
                              int A, int H,
                              int heads, int M, int depth, int N, int RP, int cfg_pair,
                              float cfg_scale, int sampler, void* stream) {
  const int dh = heads > 0 ? H / heads : 0;
  // the non-product phases' shared memory: the first stage's activation area
  const int smem_floats = bf16 ? Stage<__nv_bfloat16>::A_ELEMS / 2 : Stage<float>::A_ELEMS;
  if (RP > RPMAX || RP % 16 || A > AMAX || T + 1 > 32 || H % KC || M % KC || heads <= 0 ||
      H % heads || 3 * (T + 1) * (dh + 1) > smem_floats || H + NW > smem_floats ||
      (int8 && (!sqkv || !so || !s0 || !s1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.cond = cond;
  p.x0 = static_cast<const float*>(x0);
  p.pos = pos;
  p.xw = xw;
  p.xb = static_cast<const float*>(xb);
  p.fw = fw;
  p.fb = static_cast<const float*>(fb);
  p.wqkv = wqkv;
  p.sqkv = sqkv;
  p.bqkv = static_cast<const float*>(bqkv);
  p.wo = wo;
  p.so = so;
  p.bo = static_cast<const float*>(bo);
  p.w0 = w0;
  p.s0 = s0;
  p.b0 = static_cast<const float*>(b0);
  p.w1 = w1;
  p.s1 = s1;
  p.b1 = static_cast<const float*>(b1);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.hn = hn;
  p.qkv = qkv;
  p.attn = attn;
  p.m = m;
  p.x = static_cast<float*>(x);
  p.xp = static_cast<float*>(xp);
  p.part = static_cast<float*>(part);
  p.B = B; p.T = T; p.A = A; p.H = H; p.heads = heads; p.M = M; p.depth = depth;
  p.N = N; p.RP = RP; p.cfg_pair = cfg_pair; p.cfg_scale = cfg_scale; p.sampler = sampler;
  auto st = static_cast<cudaStream_t>(stream);
  if (int8)
    return static_cast<int>(bf16 ? launch<__nv_bfloat16, true>(p, st) : launch<float, true>(p, st));
  return static_cast<int>(bf16 ? launch<__nv_bfloat16, false>(p, st) : launch<float, false>(p, st));
}
