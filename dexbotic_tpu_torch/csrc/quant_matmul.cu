// K4: int8-weight matmul out[M, N] = (x[M, K] @ q[N, K]^T) * s[N] for Hopper
// (sm_90a), bf16 or fp32 activations, any M.
//
// Replaces the TPU kernel dexbotic_tpu/ops/quant_matmul.py:_kernel, whose
// (N block, K block) grid ran in order on one core, carrying an fp32
// accumulator in VMEM over K and converting each int8 weight tile to the
// compute dtype in VMEM.
//
// What bounds it on the card: at few rows (M <= 64) the stream of int8
// weights (K = 4096, N = 11008: 45 MB, 13.5 us at 3.35 TB/s); at prefill
// rows (hundreds to ~2k) the tensor cores (M = 832 at that shape: 75 GFLOP,
// 76 us at 989 TFLOP/s).  Design (swap A and B):
//  * a block computes a tile of out^T: 64 * NWG output channels (q's rows,
//    the wgmma M side) by BN rows of x (the wgmma N side, 8 to 256), over a
//    range of K in 64-deep steps;
//  * one producer warp streams the step's int8 q tile ([64 NWG][64] bytes,
//    TMA with 64-byte swizzle) and the activations' tile ([BN][64] bf16 per
//    part, TMA with 128-byte swizzle) into a ring of stages handed over by
//    mbarriers: every x tile is loaded once per block and step and shared by
//    all of the block's channels;
//  * each consumer warpgroup loads its 64 channels' A fragments from the
//    ring with two 32-bit shared loads per 4 weights (conflict-free under the
//    64-byte swizzle), expands int8 to bf16 in registers by the exponent-bias
//    trick (prmt into the mantissa of 2^23, one fp32 subtract, the upper half
//    of the fp32 is the exact bf16) and issues wgmma with A from registers
//    and the x tile as a K-major B; the next stage's fragments are expanded
//    while the current products run;
//  * fp32 activations are split once per call into three bf16 parts hi +
//    mid + lo (each the bf16 rounding of what the parts before it left),
//    which carry x to within 2^-24 |x|, fp32's own rounding; each 16-deep
//    step runs the three products into the same fp32 accumulator, smallest
//    part first (no TF32);
//  * a product that would leave SMs idle is split over K (the planner in
//    ops/quant_matmul.py:plan picks the tile, the split and the grid); the
//    splits write fp32 partials and a second pass sums them in split order
//    and applies the scale (deterministic);
//  * the grid runs the row tiles of one weight panel together, so that the
//    panel comes from device memory once and from L2 for the other tiles.
// Accumulation is fp32; the scale (in x's dtype) multiplies once at the end,
// as the TPU kernel's flush did.  Rows >= M and columns >= N read as zeros
// (TMA) and are not written.

#include "hopper.cuh"

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr int KSTEP = 64;  // k of one stage: 64 int8 bytes of a weight row

template <int BN, int NWG, int NP>
struct Cfg {
  static constexpr int BM = 64 * NWG;                 // output channels of a block
  static constexpr int A_BYTES = BM * KSTEP;          // int8 weights of a stage
  static constexpr int B_BYTES = BN * KSTEP * 2;      // one bf16 part of x of a stage
  static constexpr int STAGE_BYTES = A_BYTES + NP * B_BYTES;
  // prefill tiles: one block an SM; few rows: two, so that their weight
  // streams overlap
  static constexpr int BUDGET = NWG == 2 ? 200 * 1024 : 96 * 1024;
  static constexpr int FIT = BUDGET / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : (FIT < 2 ? 2 : FIT);
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static constexpr int THREADS = NWG == 2 ? 384 : 160;
};

// four int8 weights (bytes w0..w3) -> bf16 pairs lo = (w0, w1), hi = (w2, w3):
// each byte, biased to uint8, becomes the low mantissa byte of 2^23; one
// subtract leaves the integer, whose fp32 upper half is its exact bf16
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t u, uint32_t& lo, uint32_t& hi) {
  const uint32_t b = u ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(v);
  else return v;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, bf16>::value) return __float2bfloat16(v);
  else return v;
}

// (launch bounds by arithmetic, not ?:, which nvcc's host stub rejects there)
template <typename T, int BN, int NWG>
__global__ void __launch_bounds__(160 + 224 * (NWG - 1), 3 - NWG) qm_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
    const T* __restrict__ s, T* __restrict__ out, float* __restrict__ part, int M, int N, int K,
    int splits) {
  constexpr int NP = std::is_same<T, bf16>::value ? 1 : 3;
  using C = Cfg<BN, NWG, NP>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sb = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // x: [ST][NP][BN][64]
  unsigned char* sa = sb + ST * NP * C::B_BYTES;                               // q: [ST][BM][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sa + ST * C::A_BYTES);
  uint64_t* empty = full + ST;

  const int r0 = blockIdx.x * BN, ch0 = blockIdx.y * C::BM, split = blockIdx.z;
  const int steps = K / KSTEP;
  const int kb0 = int(long(split) * steps / splits);
  const int n_it = int(long(split + 1) * steps / splits) - kb0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ================= producer warp (of a warpgroup when NWG = 2) =================
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (warp > 4 * NWG || lane != 0) return;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % ST, k = (kb0 + it) * KSTEP;
      mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
      tma_load_3d(sa + st * C::A_BYTES, &tq, &full[st], k, ch0, 0);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_3d(sb + (st * NP + p) * C::B_BYTES, &tx, &full[st], k, r0, p);
    }
    return;
  }

  // ================= consumer warpgroups =================
  if constexpr (NWG == 2) reg_alloc<240>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  // A fragment of a 16-deep step kk, rows g and g + 8 of this warp's 16
  // channels: a[0] (g, 2t..2t+1), a[1] (g+8, same), a[2] (g, 2t+8..2t+9),
  // a[3] (g+8, same).  Row r's 16-byte chunk c sits at chunk c ^ ((r >> 1) & 3).
  const int ra = 64 * wg + 16 * w + g;
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;  // the halves (byte pairs) of thread t
  auto load_frags = [&](int st, uint32_t (&fa)[4][4]) {
    const unsigned char* at = sa + st * C::A_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h, sw = (row >> 1) & 3;
      const unsigned char* rp = at + row * KSTEP + 4 * (t >> 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(rp + ((kk ^ sw) << 4));
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(rp + ((kk ^ sw) << 4) + 8);
        i8x4_to_bf16x2(__byte_perm(lo, hi, sel), fa[kk][h], fa[kk][2 + h]);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t fa[2][4][4];

  // one stage: its products from fragments fa[CUR], the next stage's
  // fragments expanded while they run
  auto step = [&](auto cur, int it) {
    constexpr int CUR = decltype(cur)::value;
    const int st = it % ST;
    const unsigned char* bx = sb + st * NP * C::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = NP - 1; p >= 0; --p)  // smallest part first
        wgmma_rs_k<BN>(acc, fa[CUR][kk], desc_k(bx + p * C::B_BYTES + kk * 32), 1);
    wgmma_commit();
    if (it + 1 < n_it) {
      const int nx = (it + 1) % ST;
      mbar_wait(&full[nx], ((it + 1) / ST) & 1);
      load_frags(nx, fa[CUR ^ 1]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(fa[CUR]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  mbar_wait(&full[0], 0);
  load_frags(0, fa[0]);
  for (int it = 0; it < n_it; it += 2) {
    step(std::integral_constant<int, 0>(), it);
    if (it + 1 < n_it) step(std::integral_constant<int, 1>(), it + 1);
  }

  // acc[4 j + e]: channel 16 w + g + 8 (e >> 1) of this warpgroup's 64, x row 8 j + 2 t + (e & 1)
  const int c0 = ch0 + ra;
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sc[h] = c0 + 8 * h < N ? to_f32(s[c0 + 8 * h]) : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * j + 2 * t + (e & 1), c = c0 + 8 * (e >> 1);
      if (r >= M || c >= N) continue;
      if (splits == 1) out[size_t(r) * N + c] = from_f32<T>(acc[4 * j + e] * sc[e >> 1]);
      else part[(size_t(split) * M + r) * N + c] = acc[4 * j + e];
    }
}

// out = (sum of the splits' partials, in split order) * s
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ part, const T* __restrict__ s, T* __restrict__ out,
                  int M, int N, int splits) {
  const long e = long(blockIdx.x) * 256 + threadIdx.x;
  if (e >= long(M) * N) return;
  float v = 0.f;
  for (int i = 0; i < splits; ++i) v += part[size_t(i) * M * N + e];
  out[e] = from_f32<T>(v * to_f32(s[e % N]));
}

// fp32 x [n] -> bf16 parts xs [3][n]: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), four elements a thread
__global__ void __launch_bounds__(256)
    split_kernel(const float4* __restrict__ x, bf16* __restrict__ xs, long n) {
  const long i = (long(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 v = x[i / 4];
  float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    __nv_bfloat162 b[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b[e] = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
      r[2 * e] -= __low2float(b[e]);
      r[2 * e + 1] -= __high2float(b[e]);
    }
    *reinterpret_cast<uint2*>(xs + p * n + i) = *reinterpret_cast<const uint2*>(b);
  }
}

template <typename T, int BN, int NWG>
cudaError_t launch(const void* x, const void* q, const void* s, void* out, void* part, void* xs,
                   int M, int N, int K, int splits, cudaStream_t stream) {
  constexpr bool B16 = std::is_same<T, bf16>::value;
  constexpr int NP = B16 ? 1 : 3;
  using C = Cfg<BN, NWG, NP>;
  const void* xb = x;
  if constexpr (!B16) {
    const long n = long(M) * K;
    split_kernel<<<unsigned((n / 4 + 255) / 256), 256, 0, stream>>>(
        static_cast<const float4*>(x), static_cast<bf16*>(xs), n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xb = xs;
  }
  CUtensorMap tq, tx;
  if (!make_map_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 1, N, K, C::BM, KSTEP,
                     CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_rows(&tx, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, NP, M, K, BN, KSTEP,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instance
      qm_kernel<T, BN, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((M + BN - 1) / BN, (N + C::BM - 1) / C::BM, splits);
  qm_kernel<T, BN, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tx, static_cast<const T*>(s), static_cast<T*>(out), static_cast<float*>(part), M, N, K,
      splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  reduce_kernel<T><<<unsigned((long(M) * N + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const T*>(s), static_cast<T*>(out), M, N,
      splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(int rows, const void* x, const void* q, const void* s, void* out,
                        void* part, void* xs, int M, int N, int K, int splits,
                        cudaStream_t stream) {
  switch (rows) {
    case 8: return launch<T, 8, 1>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 16: return launch<T, 16, 1>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 32: return launch<T, 32, 1>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 64: return launch<T, 64, 1>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 128: return launch<T, 128, 2>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 192: return launch<T, 192, 2>(x, q, s, out, part, xs, M, N, K, splits, stream);
    case 256: return launch<T, 256, 2>(x, q, s, out, part, xs, M, N, K, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: x rows a block (8, 16, 32, 64 on one consumer warpgroup of 64
// channels; 128, 192, 256 on two of 128); part: fp32 [splits, M, N] when
// splits > 1; xs: bf16 [3, M, K] scratch for fp32 x.
extern "C" int dbx_quant_matmul(int bf16_x, const void* x, const void* q, const void* s,
                                void* out, void* part, void* xs, int M, int N, int K, int rows,
                                int splits, void* stream) {
  if (M < 1 || N < 1 || K < KSTEP || K % KSTEP || splits < 1 || splits > K / KSTEP ||
      (splits > 1 && part == nullptr) || (!bf16_x && xs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16_x ? launch_rows<bf16>(rows, x, q, s, out, part, xs, M, N, K, splits, st)
             : launch_rows<float>(rows, x, q, s, out, part, xs, M, N, K, splits, st));
}
