// K4: int8-weight matmul out[M, N] = (x[M, K] @ q[N, K]^T) * s[N] for Hopper
// (sm_90a), with M <= 64 rows of bf16 or fp32 activations.
//
// Replaces the TPU kernel dexbotic_tpu/ops/quant_matmul.py:_kernel, whose
// (N block, K block) grid ran in order on one core, carrying an fp32
// accumulator in VMEM over K and converting each int8 weight tile to the
// compute dtype in VMEM.
//
// What bounds it on the card: at M <= 64 the work is streaming the int8
// weights once (M=16, K=4096, N=11008: 45 MB, 13.5 us at 3.35 TB/s, against
// ~1.5 us of bf16 tensor work), so the design keeps every weight byte off any
// second trip and spreads the stream over all SMs:
// - one warp per (8 output columns, K range): each thread streams 16
//   consecutive int8 of one weight row (q is [N, K], so a column's weights are
//   contiguous) per 64-deep k step, four steps in flight, with no shared
//   memory; the activations (<= 64 x K, L2-resident) are read per step;
// - the k order inside a step is permuted so that a thread's 16 weight bytes
//   and 16 activation values are exactly the operands it owns in four
//   mma.sync m16n8k16 steps: thread t4 of a quad owns physical k 16 t4 + 4 s
//   + [0, 4) in step s, for A and for B alike, so every product pairs the
//   same k (the sum does not depend on the order);
// - int8 is exact in bf16: each byte becomes a bf16 in registers and the
//   bf16 case is the plain version's product up to summation order; fp32
//   activations are split into three bf16 parts hi + mid + lo (each the bf16
//   rounding of what the parts before it left), one product each, which
//   represents x to within 2^-24 |x|, fp32's own rounding;
// - a product with few columns (N = 768 at the DiT) is split over K so that
//   ~2100 warps stream at once; each split writes fp32 partials and a second
//   pass sums them in split order and applies the scale (deterministic).
// Accumulation is fp32; the scale (in x's dtype) multiplies once at the end,
// as the TPU kernel's flush did.  Rows >= M and columns >= N are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int WARPS = 4;     // warps per block, 8 columns each
constexpr int KSTEP = 64;    // k per step: 16 per thread of a quad
constexpr int MAX_RF = 4;    // 16-row fragments: M <= 64
constexpr int INFLIGHT = 4;  // weight loads a thread keeps in flight

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 int8 weights -> 8 bf16 pairs: pair i holds bytes 2i (low half), 2i + 1
__device__ __forceinline__ void int8_to_bf16x2(const uint4& w, uint32_t (&b)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = words[i];
    b[2 * i] = pack_bf16(float(int8_t(v & 0xff)), float(int8_t((v >> 8) & 0xff)));
    b[2 * i + 1] = pack_bf16(float(int8_t((v >> 16) & 0xff)), float(int8_t(v >> 24)));
  }
}

// 16 activations of one row (zeros past M) as bf16 pairs, in NP parts that sum
// to x: NP = 1 for bf16; 3 for fp32 (hi, mid, lo)
template <typename T, int NP>
__device__ __forceinline__ void load_row(const T* __restrict__ src, bool valid,
                                         uint32_t (&a)[NP][8]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
    if (valid) {
      v0 = __ldg(reinterpret_cast<const uint4*>(src));
      v1 = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    }
    a[0][0] = v0.x; a[0][1] = v0.y; a[0][2] = v0.z; a[0][3] = v0.w;
    a[0][4] = v1.x; a[0][5] = v1.y; a[0][6] = v1.z; a[0][7] = v1.w;
  } else {
    float f[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) v = __ldg(reinterpret_cast<const float4*>(src) + i);
      f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z; f[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float r0 = f[2 * i], r1 = f[2 * i + 1];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const __nv_bfloat16 h0 = __float2bfloat16(r0), h1 = __float2bfloat16(r1);
        a[p][i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
        r0 -= __bfloat162float(h0);
        r1 -= __bfloat162float(h1);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                        const T* __restrict__ s, T* __restrict__ out, float* __restrict__ part,
                        int M, int N, int K, int splits) {
  constexpr int NP = std::is_same<T, __nv_bfloat16>::value ? 1 : 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = (blockIdx.x * WARPS + warp) * 8;
  if (n0 >= N) return;  // no block-wide barrier below
  const int steps = K / KSTEP, split = blockIdx.y;
  const int kb0 = int(long(split) * steps / splits), kb1 = int(long(split + 1) * steps / splits);
  const int RF = (M + 15) / 16;
  const bool nvalid = n0 + g < N;
  const int8_t* qrow = q + size_t(nvalid ? n0 + g : 0) * K + 16 * t4;
  float acc[MAX_RF][4] = {};
  for (int kb = kb0; kb < kb1; kb += INFLIGHT) {
    uint4 wq[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      wq[u] = make_uint4(0, 0, 0, 0);
      if (nvalid && kb + u < kb1) wq[u] = __ldcs(reinterpret_cast<const uint4*>(qrow + size_t(kb + u) * KSTEP));
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      if (kb + u >= kb1) break;
      uint32_t b[8];
      int8_to_bf16x2(wq[u], b);
      const int k = (kb + u) * KSTEP + 16 * t4;
#pragma unroll
      for (int rf = 0; rf < MAX_RF; ++rf) {
        if (rf >= RF) break;
        const int r0 = rf * 16 + g, r1 = r0 + 8;
        uint32_t a0[NP][8], a1[NP][8];
        load_row<T, NP>(x + size_t(r0) * K + k, r0 < M, a0);
        load_row<T, NP>(x + size_t(r1) * K + k, r1 < M, a1);
#pragma unroll
        for (int p = NP - 1; p >= 0; --p)  // smallest part first
#pragma unroll
          for (int st = 0; st < 4; ++st)
            mma16816(acc[rf], a0[p][2 * st], a1[p][2 * st], a0[p][2 * st + 1], a1[p][2 * st + 1],
                     b[2 * st], b[2 * st + 1]);
      }
    }
  }
  // c0, c1: row g, columns 2 t4, 2 t4 + 1; c2, c3: row g + 8
  const int c = n0 + 2 * t4;
#pragma unroll
  for (int rf = 0; rf < MAX_RF; ++rf) {
    if (rf >= RF) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rf * 16 + g + (i >> 1) * 8, cc = c + (i & 1);
      if (r >= M || cc >= N) continue;
      if (splits == 1) {
        float sc;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) sc = __bfloat162float(s[cc]); else sc = s[cc];
        const float v = acc[rf][i] * sc;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) out[size_t(r) * N + cc] = __float2bfloat16(v);
        else out[size_t(r) * N + cc] = v;
      } else {
        part[(size_t(split) * M + r) * N + cc] = acc[rf][i];
      }
    }
  }
}

// out = (sum of the splits' partials, in split order) * s
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, const T* __restrict__ s, T* __restrict__ out,
                  int M, int N, int splits) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= M * N) return;
  float v = 0.f;
  for (int i = 0; i < splits; ++i) v += part[size_t(i) * M * N + e];
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    out[e] = __float2bfloat16(v * __bfloat162float(s[e % N]));
  else
    out[e] = v * s[e % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const void* s, void* out, void* part, int M,
                   int N, int K, int splits, cudaStream_t stream) {
  const dim3 grid((N + WARPS * 8 - 1) / (WARPS * 8), splits);
  quant_matmul_kernel<T><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const T*>(s),
      static_cast<T*>(out), static_cast<float*>(part), M, N, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  reduce_kernel<T><<<(M * N + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const T*>(s), static_cast<T*>(out), M, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dbx_quant_matmul(int bf16, const void* x, const void* q, const void* s, void* out,
                                void* part, int M, int N, int K, int splits, void* stream) {
  if (M < 1 || M > MAX_RF * 16 || N < 1 || K < KSTEP || K % KSTEP || splits < 1 ||
      splits > K / KSTEP || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<__nv_bfloat16>(x, q, s, out, part, M, N, K, splits, st)
                               : launch<float>(x, q, s, out, part, M, N, K, splits, st));
}
