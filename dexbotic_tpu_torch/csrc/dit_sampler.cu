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
// What bounds it on the card: at serving batch (2 to 16 rows of 17 tokens)
// every product is a skinny [<= 288, K] x [K, N] one, so the work is
// streaming the DiT-B weights (~14 MB bf16 per layer, ~170 MB per step, more
// than the 50 MB L2) plus the latency of the ~110 dependent phases of a step.
// Launched as eager PyTorch ops, each phase would be a separate kernel and
// the loop launch-bound.
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, one
// block of two warpgroups per SM, the occupancy calculator checking that it
// fits) that walks every (step, layer, phase) itself and separates phases
// with cooperative_groups grid.sync().  The product phases (bf16 and int8
// block weights) are swap-AB wgmma over a TMA ring, built from hopper.cuh:
//  * the block weights are stacked K-major, [depth * N, K] per linear, and
//    read through one tensor map each: [128 channels][64 k] boxes, 128-byte
//    swizzle for bf16, 64-byte for int8;
//  * a product item is 128 output channels (64 a warpgroup, the wgmma M
//    side) by one N tile of the activations' rows (BN = 24, 40 or 72 padded
//    rows, the wgmma N side; 272 rows are four tiles of 72, whose weights
//    the second to fourth item read from L2) by a k chunk;
//    the wrapper's planner (ops/dit_fused.py:plan) picks the chunks of each
//    product for the row count and passes them in Params;
//  * a stage of the ring holds one 64-deep k step: the weights' box and the
//    activations' [BN][64] box (bf16, 128-byte swizzle), both by TMA on one
//    mbarrier that takes two arrivals, one for each;
//  * weights do not depend on activations: thread 0 requests the weights of
//    the block's first stages of the next product at the start of the
//    non-product phase that follows a product (the TPU kernel's prefetch of
//    layer j + 1), so they stream in during that phase and its barrier; the
//    activations follow after the grid barrier, behind a
//    fence.proxy.async.global, since the phase before wrote them through
//    the generic proxy (every thread also fences before each barrier);
//  * bf16: wgmma with both operands from shared memory (K-major
//    descriptors); int8: each warpgroup loads its A fragments from the ring,
//    expands int8 by K4's prmt trick and dequantizes every weight as
//    rnd<bf16>(float(q) * float(s)), the TPU kernel's `w.astype(cdtype) *
//    s.astype(cdtype)`, then wgmma with A from registers;
//  * each item's fp32 product goes to its chunk's plane of the global
//    partials [chunks, RP, N]; the next phase sums an element's planes in
//    chunk order (a bias phase for qkv, a bias + GELU phase for fc0, a
//    residual + LayerNorm phase for o-proj and fc1), so the result does not
//    depend on timing and repeats bit for bit.
// The ring's position and mbarrier parity are one counter of the block's
// stages, the same in every thread, carried across products, layers and
// steps; the block's items of each product are a table built once in
// shared memory, so thread 0 spends no integer division on a request.  The ring never holds more than STAGES steps; a block with more in
// one product refills a stage once all its threads are past it.  The
// non-product phases use their own shared memory, which no TMA writes.
// Activations (<= 288 x 3072) live in global scratch that the wrapper
// allocates; their padded rows stay zero.
// Numerics follow the TPU kernel: products accumulate in fp32 and round to
// the weight dtype, LayerNorm/softmax/scheduler math is fp32, the residual
// stream is kept in the weight dtype.  The fp32-weight instance (off the
// served path) runs the same items with plain FMA from global memory.
//
// Probe (Params::probe, null on the served path): every block's thread 0
// stamps %globaltimer at the start and the end of every (step, layer,
// phase), with the cycles a product phase waited for its stages and the
// cycles of the rest of it (of which: its partial stores, and its requests
// at the start); read by script/probe_dit_sampler_torch.py.

#include "hopper.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr int NW = 8;  // warps per block: two consumer warpgroups
constexpr int NTHREADS = NW * 32;
constexpr int AMAX = 16;    // action dim
constexpr int KSTEP = 64;   // k of one stage
constexpr int CB = 128;     // output channels of a product item: 64 a warpgroup
constexpr int BN_MAX = 72;  // rows of an N tile
constexpr int NT_MAX = 4;   // N tiles: at most 288 rows
constexpr int STAGES = 7;
constexpr int W_BYTES = CB * KSTEP * 2;       // a stage's bf16 weights (int8: half)
constexpr int A_BYTES = BN_MAX * KSTEP * 2;   // a stage's activations, 9 x 1024 bytes
constexpr int RING_BYTES = STAGES * (W_BYTES + A_BYTES);
constexpr int SCRATCH_BYTES = 25 * 1024;      // the non-product phases' shared memory
constexpr int MAX_ITEMS = 24;  // a block's items in one product
constexpr int TABLE_BYTES = 4 * MAX_ITEMS * 20 + 32;  // the block's items of each product (Table)
constexpr int PROBE_BYTES = 64;  // thread 0's probe sums of the current phase
constexpr int TAIL_BYTES = STAGES * 8 + TABLE_BYTES + PROBE_BYTES;  // mbarriers, Table, Probe
constexpr int SMEM_TC = 1024 + RING_BYTES + SCRATCH_BYTES + TAIL_BYTES;
constexpr int SMEM_FMA = SCRATCH_BYTES + TAIL_BYTES;
static_assert(SMEM_TC <= 227 * 1024, "one block an SM: at most 227 KB of shared memory");
constexpr int PHASES = 9;  // phases of a layer
constexpr float LN_EPS = 1e-6f;

// products: 0 qkv [3H, H], 1 o [H, H], 2 fc0 [M, H], 3 fc1 [H, M] ([N, K])
struct Params {
  const float* coef;  // [N, 6] scheduler coefficients, execution order
  const void* cond;   // [N, rows, H] condition token per step
  const float* x0;    // [B, T, A] initial noise
  const void* pos;    // [S, H]
  const void* xw;     // [A, H]
  const float* xb;    // [H]
  const void* fw;     // [H, A]
  const float* fb;    // [A]
  const void* w[4];   // block weights [depth, N, K] (weight dtype, or int8)
  const void* s[4];   // int8 only: [depth, N] scales in the weight dtype
  const float* b[4];  // [depth, N] biases
  float* out;  // [B, T, A]
  void* h;     // [RP, H] residual stream
  void* hn;    // [RP, H] LayerNorm output
  void* qkv;   // [RP, 3H]
  void* attn;  // [RP, H]
  void* m;     // [RP, M]
  float* x;    // [B, T, A] current sample
  float* xp;   // [B, T, A] DPM x0 of the previous step
  float* part;  // [chunks, RP, N] partial products of the last product phase
  int B, T, A, H, heads, M, depth, N, RP, cfg_pair;
  float cfg_scale;
  int sampler;    // 0 ddim, 1 dpm
  int bn, nt;     // rows of an N tile and N tiles: RP = bn * nt
  int chunks[4];  // k chunks of each product (the plan)
  unsigned long long* probe;  // null, or [G][4] header + [N][3 + 9 depth][G][PROBE_WORDS] records
};

// tensor maps of the tensor-core instances
struct Maps {
  CUtensorMap w[4];  // block weights as [depth * N, K]
  CUtensorMap a[3];  // activations hn, attn, m as [RP, K]
};

// A probe record is PROBE_WORDS uint64: the phase's start and end
// (%globaltimer), and for a product phase the cycles it waited for its
// stages, the cycles of the rest, and of that rest the cycles of the partial
// stores and of thread 0's requests at the phase's start.
constexpr int PROBE_WORDS = 6;
struct Probe {  // in shared memory, written by thread 0 only
  unsigned long long t0, wait, prod, store, issue;
};
static_assert(sizeof(Probe) <= PROBE_BYTES, "PROBE_BYTES holds the Probe");

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned clock32() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(c));
  return c;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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
__device__ void bias_act_phase(const Params& p, const float* __restrict__ bias, int N, int nc, void* out) {
  T* o = static_cast<T*>(out);
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < num_rows(p) * N; e += gridDim.x * NTHREADS) {
    const float y = rnd<T>(part_sum(p, nc, N, e / N, e % N) + bias[e % N]);
    o[e] = from_f<T>(GELU ? gelu_tanh(y) : y);
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

// ---- the product phases ----
// part[c, r, n] = sum over the k steps of chunk c of A[r, k] W[n, k].  An
// item is (chunk c, channel block cb, N tile rt), numbered
// i = (c * N / CB + cb) * nt + rt; chunk c covers k steps
// [c * ks / nc, (c + 1) * ks / nc) of ks = K / 64; block b takes items
// [b * total / G, (b + 1) * total / G).  ops/dit_fused.py:Plan.items is the
// same walk, for the tests.

__device__ __forceinline__ int prod_n(const Params& p, int id) {
  return id == 0 ? 3 * p.H : id == 2 ? p.M : p.H;
}
__device__ __forceinline__ int prod_k(const Params& p, int id) { return id == 3 ? p.M : p.H; }
__device__ __forceinline__ int prod_act(int id) { return id == 1 ? 1 : id == 3 ? 2 : 0; }  // hn, attn, m

struct Item {
  int c, cb, rt, ks0, ks1;
};

__device__ __forceinline__ Item item_at(const Params& p, int id, int i) {
  const int nb = prod_n(p, id) / CB, ks = prod_k(p, id) / KSTEP, nc = p.chunks[id];
  Item it;
  it.rt = i % p.nt;
  it.cb = (i / p.nt) % nb;
  it.c = i / (p.nt * nb);
  it.ks0 = it.c * ks / nc;
  it.ks1 = (it.c + 1) * ks / nc;
  return it;
}

__device__ __forceinline__ void item_range(const Params& p, int id, int& first, int& last) {
  const int total = p.chunks[id] * (prod_n(p, id) / CB) * p.nt, G = gridDim.x;
  first = blockIdx.x * total / G;  // < 132 * 2304: int
  last = (blockIdx.x + 1) * total / G;
}

// The block's items of each product and its stages (k steps) in each, the
// same in every layer and step: built once, in shared memory, so that a
// product phase spends no integer division on its walk.
struct Table {
  Item items[4][MAX_ITEMS];
  int count[4], steps[4];
};
static_assert(sizeof(Table) <= TABLE_BYTES, "TABLE_BYTES holds the Table");

__device__ void build_table(const Params& p, Table* tab) {
  if (threadIdx.x < 4) {
    const int id = threadIdx.x;
    int first, last, n = 0;
    item_range(p, id, first, last);
    for (int i = first; i < last; ++i) {
      const Item it = item_at(p, id, i);
      tab->items[id][i - first] = it;
      n += it.ks1 - it.ks0;
    }
    tab->count[id] = last - first;
    tab->steps[id] = n;
  }
  __syncthreads();
}

// thread 0's walk through the block's stages of one product, in order
struct Cursor {
  int j, count, ks;
  Item it;
  __device__ __forceinline__ void begin(const Table* tab, int id) {
    j = 0;
    count = tab->count[id];
    if (count > 0) {
      it = tab->items[id][0];
      ks = it.ks0;
    }
  }
  __device__ __forceinline__ bool done() const { return j >= count; }
  __device__ __forceinline__ void next(const Table* tab, int id) {
    if (++ks >= it.ks1 && ++j < count) {
      it = tab->items[id][j];
      ks = it.ks0;
    }
  }
};

struct Ring {
  unsigned char* w;  // [STAGES][W_BYTES]
  unsigned char* a;  // [STAGES][A_BYTES]
  uint64_t* full;    // [STAGES]: two arrivals a use, the weights' and the activations'
};

// Request the cursor's stage of product `id` of `layer` into ring stage st:
// its weights (ACTS false) or its activations, onto the stage's mbarrier.
template <bool Q, bool ACTS>
__device__ __forceinline__ void issue(const Params& p, const Maps& maps, const Ring& r, int id, int layer,
                                      int st, const Cursor& c) {
  const int k = c.ks * KSTEP;
  if constexpr (ACTS) {
    mbar_arrive_expect_tx(&r.full[st], p.bn * KSTEP * 2);
    tma_load_3d(r.a + st * A_BYTES, &maps.a[prod_act(id)], &r.full[st], k, c.it.rt * p.bn, 0);
  } else {
    mbar_arrive_expect_tx(&r.full[st], Q ? W_BYTES / 2 : W_BYTES);
    tma_load_3d(r.w + st * W_BYTES, &maps.w[id], &r.full[st], k, layer * prod_n(p, id) + c.it.cb * CB, 0);
  }
}

// The weights of the block's first stages of product `id` of `layer` (`seq`:
// the block's stages before it), into the ring behind the previous
// product's stages: every stage is free, since the phase that issues them
// follows that product's grid barrier.
template <bool Q>
__device__ void prefetch(const Params& p, const Maps& maps, const Ring& r, const Table* tab, int id,
                         int layer, int seq) {
  if (threadIdx.x != 0) return;
  Cursor c;
  c.begin(tab, id);
  for (int t = 0; t < STAGES && !c.done(); ++t, c.next(tab, id))
    issue<Q, false>(p, maps, r, id, layer, (seq + t) % STAGES, c);
}

// four int8 weights (bytes w0..w3) of one channel -> bf16 pairs lo = (w0, w1),
// hi = (w2, w3), each dequantized as rnd<bf16>(float(q) * s): each byte,
// biased to uint8, becomes the low mantissa byte of 2^23; one subtract leaves
// the integer exactly (K4's expand), then one multiply and one rounding
__device__ __forceinline__ void i8x4_dequant(uint32_t u, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t b = u ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = pack_bf16(f0 * s, f1 * s);
  hi = pack_bf16(f2 * s, f3 * s);
}

// The dequantized A fragment of 16-deep k step kk of a stage, rows `row`
// and row + 8 of the [128][64] int8 box (64-byte swizzle: row r's 16-byte
// chunk c sits at chunk c ^ ((r >> 1) & 3)): {(row, 2t..2t+1), (row + 8,
// same), (row, 2t+8..2t+9), (row + 8, same)}, as K4 loads them.
__device__ __forceinline__ void dequant_frag(const unsigned char* ws, int row, int t, int kk,
                                             const float (&sc)[2], uint32_t (&fa)[4]) {
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;  // the halves (byte pairs) of thread t
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = row + 8 * h, sw = (rr >> 1) & 3;
    const unsigned char* rp = ws + rr * KSTEP + 4 * (t >> 1) + ((kk ^ sw) << 4);
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(rp);
    const uint32_t hi = *reinterpret_cast<const uint32_t*>(rp + 8);
    i8x4_dequant(__byte_perm(lo, hi, sel), sc[h], fa[h], fa[2 + h]);
  }
}

// Product `id` of `layer` on the tensor cores, N tiles of BN rows; returns
// the block's stages in it.  The weights of its first stages were requested
// by prefetch(); thread 0 requests their activations now, and each later
// stage (weights and activations) once the stage STAGES before it is free.
template <bool Q, int BN>
__device__ int product_tc(const Params& p, const Maps& maps, const Ring& r, const Table* tab, int id,
                          int layer, int seq, Probe* pb) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4, w = warp % 4;
  const int g = lane / 4, t4 = lane % 4, N = prod_n(p, id);
  const unsigned c_in = clock32();  // the probe's cycle counts
  unsigned waited = 0;
  Cursor next;  // thread 0: the next stage to request
  if (tid == 0) {
    fence_proxy_async_global();  // the activations were written before the barrier
    next.begin(tab, id);
    for (int t = 0; t < STAGES && !next.done(); ++t, next.next(tab, id))
      issue<Q, true>(p, maps, r, id, layer, (seq + t) % STAGES, next);
  }
  const int n = tab->steps[id];
  const unsigned c_issued = clock32();
  unsigned stored = 0;
  const bf16* scales = Q ? static_cast<const bf16*>(p.s[id]) + size_t(layer) * N : nullptr;
  float acc[BN / 2];
  int t = 0;
  for (int j = 0; j < tab->count[id]; ++j) {
    const Item it = tab->items[id][j];
    const int row = 64 * wg + 16 * w + g;  // this thread's channels in the item: row, row + 8
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
    float sc[2] = {0.f, 0.f};
    if constexpr (Q) {
      sc[0] = __bfloat162float(scales[it.cb * CB + row]);
      sc[1] = __bfloat162float(scales[it.cb * CB + row + 8]);
    }
    for (int ks = it.ks0; ks < it.ks1; ++ks, ++t) {
      const int st = (seq + t) % STAGES;
      const unsigned cw = clock32();
      mbar_wait(&r.full[st], ((seq + t) / STAGES) & 1);
      waited += clock32() - cw;
      const unsigned char* ws = r.w + st * W_BYTES;
      const unsigned char* as = r.a + st * A_BYTES;
      if constexpr (Q) {  // two fragments in turn: k step kk's expands while kk - 1 multiplies
        uint32_t fa[2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= 2) {
            wgmma_wait<1>();  // k step kk - 2, which read fa[kk & 1], is done
            fence_regs(fa);
          }
          dequant_frag(ws, row, t4, kk, sc, fa[kk & 1]);
          wgmma_fence();
          wgmma_rs_k<BN>(acc, fa[kk & 1], desc_k(as + kk * 32), 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(fa);
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN>(acc, desc_k(ws + wg * 64 * 128 + kk * 32), desc_k(as + kk * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(acc);
      if (t + STAGES < n) {  // refill this stage once every thread is past it
        named_barrier(1, NTHREADS);
        if (tid == 0) {
          issue<Q, false>(p, maps, r, id, layer, st, next);
          issue<Q, true>(p, maps, r, id, layer, st, next);
          next.next(tab, id);
        }
      }
    }
    // acc[4 j + e]: channel row + 8 (e >> 1), row 8 j + 2 t4 + (e & 1) of the N tile
    const unsigned cs = clock32();
    float* dst = p.part + size_t(it.c) * p.RP * N + size_t(it.rt) * BN * N + it.cb * CB + row;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[size_t(8 * j + 2 * t4 + (e & 1)) * N + 8 * (e >> 1)] = acc[4 * j + e];
    stored += clock32() - cs;
  }
  if (pb != nullptr && tid == 0) {
    pb->wait += waited;
    pb->prod += clock32() - c_in - waited;
    pb->store += stored;
    pb->issue += c_issued - c_in;
  }
  return n;
}

// The fp32-weight instance's product: the same items, plain FMA, weights and
// activations from global memory (L1 and L2).  Thread (channel c, half h)
// takes rows h, h + 2, ... of the item's N tile, four at a time.
template <bool Q>
__device__ void product_fma(const Params& p, const Table* tab, int id, int layer,
                            const float* __restrict__ A) {
  using WT = typename std::conditional<Q, int8_t, float>::type;
  const int N = prod_n(p, id), K = prod_k(p, id), c = threadIdx.x % CB, half = threadIdx.x / CB;
  for (int j = 0; j < tab->count[id]; ++j) {
    const Item it = tab->items[id][j];
    const int n = it.cb * CB + c;
    const WT* wr = static_cast<const WT*>(p.w[id]) + (size_t(layer) * N + n) * K;
    const float sc = Q ? static_cast<const float*>(p.s[id])[size_t(layer) * N + n] : 1.f;
    const int r0 = it.rt * p.bn;
    float* dst = p.part + size_t(it.c) * p.RP * N + n;
    for (int rr = half; rr < p.bn; rr += 8) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = it.ks0 * KSTEP; k < it.ks1 * KSTEP; ++k) {
        const float wv = Q ? float(wr[k]) * sc : float(wr[k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += A[size_t(r0 + rr + 2 * q) * K + k] * wv;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[size_t(r0 + rr + 2 * q) * N] = acc[q];
    }
  }
}

template <typename T, bool Q>
__device__ int product(const Params& p, const Maps& maps, const Ring& r, const Table* tab, int id,
                       int layer, int seq, const void* acts, Probe* pb) {
  if constexpr (std::is_same<T, bf16>::value) {
    switch (p.bn) {
      case 24: return product_tc<Q, 24>(p, maps, r, tab, id, layer, seq, pb);
      case 40: return product_tc<Q, 40>(p, maps, r, tab, id, layer, seq, pb);
      default: return product_tc<Q, 72>(p, maps, r, tab, id, layer, seq, pb);
    }
  } else {
    product_fma<Q>(p, tab, id, layer, static_cast<const float*>(acts));
    return 0;
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(NTHREADS, 1)
    dit_sample_kernel(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  // [ring (tensor-core instances)][scratch][mbarriers][Table][Probe]
  unsigned char* tail = TC ? base + RING_BYTES + SCRATCH_BYTES : smem_raw + SCRATCH_BYTES;
  Ring ring{base, base + STAGES * W_BYTES, reinterpret_cast<uint64_t*>(tail)};
  float* sm = reinterpret_cast<float*>(TC ? base + RING_BYTES : smem_raw);  // the other phases' view
  Table* const tab = reinterpret_cast<Table*>(tail + STAGES * 8);
  Probe* const pb = p.probe == nullptr ? nullptr : reinterpret_cast<Probe*>(tail + STAGES * 8 + TABLE_BYTES);
  build_table(p, tab);
  if constexpr (TC) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&ring.full[s], 2);
      fence_barrier_init();
    }
    __syncthreads();
  }
  cg::grid_group grid = cg::this_grid();
  unsigned long long* const hdr = p.probe ? p.probe + 4 * blockIdx.x : nullptr;
  const bool stamp = hdr != nullptr && threadIdx.x == 0;
  if (stamp) {
    hdr[0] = clock64();
    hdr[1] = gtimer();
  }
  const int slots = 3 + PHASES * p.depth;
  int ph = 0;
  // end of a phase: its probe record, then the grid barrier
  auto sync = [&](int step) {
    if (stamp) {
      unsigned long long* rec =
          p.probe + 4 * gridDim.x + (size_t(step * slots + ph) * gridDim.x + blockIdx.x) * PROBE_WORDS;
      rec[0] = pb->t0;
      rec[1] = gtimer();
      rec[2] = pb->wait;
      rec[3] = pb->prod;
      rec[4] = pb->store;
      rec[5] = pb->issue;
    }
    ++ph;
    if constexpr (TC) fence_proxy_async_global();  // this phase's writes, before later TMA reads
    grid.sync();
    if (stamp) *pb = Probe{gtimer(), 0, 0, 0, 0};
  };
  const int H = p.H, M = p.M, n = p.B * p.T * p.A;
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < n; e += gridDim.x * NTHREADS) {
    p.x[e] = p.x0[e];
    p.xp[e] = 0.f;
  }
  grid.sync();
  int seq = 0;  // the block's stages so far: ring position and parity
  if constexpr (TC) prefetch<Q>(p, maps, ring, tab, 0, 0, seq);
  for (int step = 0; step < p.N; ++step) {
    ph = 0;
    if (stamp) *pb = Probe{gtimer(), 0, 0, 0, 0};
    embed_phase<T>(p, step);
    sync(step);
    residual_ln_phase<T>(p, nullptr, 0, sm);
    sync(step);
    for (int j = 0; j < p.depth; ++j) {
      seq += product<T, Q>(p, maps, ring, tab, 0, j, seq, p.hn, pb);
      sync(step);
      if constexpr (TC) prefetch<Q>(p, maps, ring, tab, 1, j, seq);
      bias_act_phase<T, false>(p, p.b[0] + size_t(j) * 3 * H, 3 * H, p.chunks[0], p.qkv);
      sync(step);
      attn_phase<T>(p, sm);
      sync(step);
      seq += product<T, Q>(p, maps, ring, tab, 1, j, seq, p.attn, pb);
      sync(step);
      if constexpr (TC) prefetch<Q>(p, maps, ring, tab, 2, j, seq);
      residual_ln_phase<T>(p, p.b[1] + size_t(j) * H, p.chunks[1], sm);
      sync(step);
      seq += product<T, Q>(p, maps, ring, tab, 2, j, seq, p.hn, pb);
      sync(step);
      if constexpr (TC) prefetch<Q>(p, maps, ring, tab, 3, j, seq);
      bias_act_phase<T, true>(p, p.b[2] + size_t(j) * M, M, p.chunks[2], p.m);
      sync(step);
      seq += product<T, Q>(p, maps, ring, tab, 3, j, seq, p.m, pb);
      sync(step);
      if constexpr (TC) {  // the next layer's qkv, or the first layer's of the next step
        if (j + 1 < p.depth) prefetch<Q>(p, maps, ring, tab, 0, j + 1, seq);
        else if (step + 1 < p.N) prefetch<Q>(p, maps, ring, tab, 0, 0, seq);
      }
      residual_ln_phase<T>(p, p.b[3] + size_t(j) * H, p.chunks[3], sm);
      sync(step);
    }
    final_phase<T>(p, step, sm);
    sync(step);
  }
  if (stamp) {
    hdr[2] = clock64();
    hdr[3] = gtimer();
  }
}

template <typename T, bool Q>
cudaError_t launch(const Params& p, const Maps& maps, cudaStream_t stream) {
  constexpr int smem = std::is_same<T, bf16>::value ? SMEM_TC : SMEM_FMA;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      dit_sample_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int occ = 0, dev = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, dit_sample_kernel<T, Q>, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  // One block per SM: the items already spread every product over all SMs,
  // and a grid barrier costs more the more blocks it waits for.
  Params lp = p;
  Maps lm = maps;
  void* args[] = {&lp, &lm};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dit_sample_kernel<T, Q>), dim3(sms),
                                    dim3(NTHREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// bf16: the weight dtype is bf16 (else fp32); int8: the block weights are
// int8 with scales.  bn, nt: the N tile (24, 40 or 72 rows) and the tiles
// (up to 4), RP = bn * nt; chunks_*: the plan's k chunks of each product.
// probe: null, or uint64 [G * 4 + N * (3 + 9 depth) * G * 6] with G the SM count.
extern "C" int dbx_dit_sample(int bf16_w, int int8, const void* coef, const void* cond,
                              const void* x0, const void* pos, const void* xw, const void* xb,
                              const void* fw, const void* fb, const void* wqkv, const void* sqkv,
                              const void* bqkv, const void* wo, const void* so, const void* bo,
                              const void* w0, const void* s0, const void* b0, const void* w1,
                              const void* s1, const void* b1, void* out, void* h, void* hn, void* qkv,
                              void* attn, void* m, void* x, void* xp, void* part, int B, int T,
                              int A, int H, int heads, int M, int depth, int N, int RP, int cfg_pair,
                              float cfg_scale, int sampler, int bn, int nt, int chunks_qkv,
                              int chunks_o, int chunks_fc0, int chunks_fc1, void* probe,
                              void* stream) {
  const int dh = heads > 0 ? H / heads : 0, S = T + 1, rows = (cfg_pair ? 2 : 1) * B;
  const int chunks[4] = {chunks_qkv, chunks_o, chunks_fc0, chunks_fc1};
  const int ksteps[4] = {H / KSTEP, H / KSTEP, H / KSTEP, M / KSTEP};
  const int scratch_floats = SCRATCH_BYTES / 4;
  bool bad = !(bn == 24 || bn == 40 || bn == 72) || nt < 1 || nt > NT_MAX ||
             RP != bn * nt || rows * S > RP || B < 1 || A < 1 || A > AMAX || S > 32 || H % CB ||
             M % CB || heads <= 0 || H % heads || 3 * S * (dh + 1) > scratch_floats ||
             H + NW > scratch_floats || depth < 1 || N < 1 ||
             (int8 && (!sqkv || !so || !s0 || !s1));
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int channels[4] = {3 * H, H, M, H};
  for (int i = 0; i < 4; ++i)  // the chunks, and the items a block takes (Table)
    bad |= chunks[i] < 1 || chunks[i] > ksteps[i] ||
           (chunks[i] * (channels[i] / CB) * nt + sms - 1) / sms > MAX_ITEMS;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.cond = cond;
  p.x0 = static_cast<const float*>(x0);
  p.pos = pos;
  p.xw = xw;
  p.xb = static_cast<const float*>(xb);
  p.fw = fw;
  p.fb = static_cast<const float*>(fb);
  const void* ws[4] = {wqkv, wo, w0, w1};
  const void* ss[4] = {sqkv, so, s0, s1};
  const void* bs[4] = {bqkv, bo, b0, b1};
  for (int i = 0; i < 4; ++i) {
    p.w[i] = ws[i];
    p.s[i] = ss[i];
    p.b[i] = static_cast<const float*>(bs[i]);
    p.chunks[i] = chunks[i];
  }
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
  p.bn = bn;
  p.nt = nt;
  p.probe = static_cast<unsigned long long*>(probe);
  Maps maps;
  if (bf16_w) {  // the weights [depth * N, K] in [128][64] boxes, the activations [RP, K] in [bn][64]
    const int wn[4] = {3 * H, H, M, H}, wk[4] = {H, H, H, M};
    const auto wtype = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto wswizzle = int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    for (int i = 0; i < 4; ++i)
      if (!make_map_rows(&maps.w[i], ws[i], wtype, int8 ? 1 : 2, 1, depth * wn[i], wk[i], CB, KSTEP,
                         wswizzle))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* as[3] = {hn, attn, m};
    const int ak[3] = {H, H, M};
    for (int i = 0; i < 3; ++i)
      if (!make_map_rows(&maps.a[i], as[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1, RP, ak[i], bn, KSTEP,
                         CU_TENSOR_MAP_SWIZZLE_128B))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (int8)
    return static_cast<int>(bf16_w ? launch<bf16, true>(p, maps, st) : launch<float, true>(p, maps, st));
  return static_cast<int>(bf16_w ? launch<bf16, false>(p, maps, st) : launch<float, false>(p, maps, st));
}
