// The int8 denoiser's product glue: kernels Q8 and E8, the two
// memory-bound passes around the bf16 tensor-core GEMM of an int8
// activation product (ops/cuda/int8_product.py).
//
// Replaces no Pallas kernel: the JAX package's pdot_int8act
// (tortoise_tpu/ops/basic.py) and the int8 branch of conv1d_nwc
// (tortoise_tpu/ops/conv.py) leave the row quantize, the scales, the tap
// sums, the cast and the bias to XLA, which fuses them. Eagerly on the
// card each of the denoiser's 59 int8 products an eval ran ~10-14 passes
// over (4352, 1024-3072) maps, most of them in f32. Over x (B, T, K)
// and an int8 weight pair (w (k K, N), scale (N)), k = 2 pad + 1 taps:
//   Q8: s[r] = max(absmax(x[r]), 1e-12) / 127              (f32, IEEE /)
//       q[r] = clamp(rint(x[r] / s[r]), -127, 127)         (as bf16: exact)
//       written into a (B, T + 2 pad, K) buffer whose pad rows hold zero
//       codes and a zero scale (the eager chain's F.pad of both)
//   GEMM (ops/basic.py mm_bf16, unchanged): acc_j = q @ w_j, f32, one
//       call per tap over the flattened buffer
//   E8: y = ((acc_0[r] s[r] + acc_1[r+1] s[r+1]) + acc_2[r+2] s[r+2])
//           * scale, r = b (T + 2 pad) + t; k = 1: y = acc s scale
//       out = round(y) + bias in out's type (bf16: both rounded to bf16,
//       added in f32, rounded once, as PyTorch adds two bf16 tensors)
// Every operation is the eager chain's own, in its order and rounding:
// a true division (__fdiv_rn, not a reciprocal multiply), rintf (half
// to even, as torch.round), products and sums as __fmul_rn / __fadd_rn
// (nvcc would contract a * b + c into one FMA, which rounds once). A
// tap's sums are exact integers in any order while K 127^2 < 2^24, so
// the GEMM over the padded buffer gives the eager per-tap slices' bits;
// the wrapper refuses a conv past that K.
//
// What bounds them: bytes. At the denoiser's M = 2 x 2176 rows, Q8 reads
// a bf16 row of K = 1024 and writes it back as codes (17.8 MB, ~5.3 us at
// 3.35 TB/s); E8 reads the f32 sums and writes bf16 (k1 N 1024: 26.7 MB;
// qkv N 3072: 80.2 MB; k3: 62.4 MB).
//
// Design: Q8 takes one warp a row, the row held in registers (16-byte
// loads, 4, 8 or 16 a lane by K), its absmax from a warp shuffle, then the
// codes written from registers; no shared memory, no block barrier. E8
// takes one thread a 4-column group of one output row (16-byte loads of
// each tap and of the scales, the row scales broadcast from L1).
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // Q8: warps (rows) a block
constexpr int kMaxVec = 16;       // Q8: 16-byte vectors a lane holds, at most
constexpr int kEpiThreads = 256;  // E8: threads a block

// 16 bytes of x's type as floats, and the same values as bf16 codes
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  static constexpr int kV = 8;
  using Codes = uint4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ Codes pack(const float* v) {
    return make_uint4(tt::pack_bf16(v[0], v[1]), tt::pack_bf16(v[2], v[3]),
                      tt::pack_bf16(v[4], v[5]), tt::pack_bf16(v[6], v[7]));
  }
};
template <>
struct Row<float> {
  static constexpr int kV = 4;
  using Codes = uint2;
  __device__ static __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ Codes pack(const float* v) {
    return make_uint2(tt::pack_bf16(v[0], v[1]), tt::pack_bf16(v[2], v[3]));
  }
};

// Q8: one warp an output row of the (B, T + 2 pad, K) code buffer, kVec
// 16-byte vectors of the row a lane (the fewest of 4, 8, 16 that hold it:
// registers for 16 at K = 1024 cost three quarters of the occupancy)
template <typename X, int kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    q8_rows(const X* __restrict__ x, __nv_bfloat16* __restrict__ codes,
            float* __restrict__ s_out, int B, int T, int K, int pad) {
  using R = Row<X>;
  constexpr int V = R::kV;
  const int lane = threadIdx.x & 31;
  const int tp = T + 2 * pad;
  const long long r =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= (long long)B * tp) return;
  const int nv = K / V;
  typename R::Codes* out =
      reinterpret_cast<typename R::Codes*>(codes + r * K);
  const int t = (int)(r % tp) - pad;
  if (t < 0 || t >= T) {  // a pad row: zero codes, zero scale
    for (int v = lane; v < nv; v += 32) out[v] = typename R::Codes{};
    if (lane == 0) s_out[r] = 0.f;
    return;
  }
  const uint4* row =
      reinterpret_cast<const uint4*>(x + ((r / tp) * T + t) * K);
  uint4 raw[kVec];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      raw[i] = __ldg(row + v);
      float f[V];
      R::unpack(raw[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
  amax = tt::warp_max(amax);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      float f[V];
      R::unpack(raw[i], f);
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[e] = fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.f), 127.f);
      out[v] = R::pack(f);
    }
  }
  if (lane == 0) s_out[r] = s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// E8: one thread 4 columns of one output row. bias_kind: 0 none, 1 f32,
// 2 bf16.
template <int kTaps, typename OutT>
__global__ void __launch_bounds__(kEpiThreads)
    e8_epilogue(const float* __restrict__ tap0,
                const float* __restrict__ tap1,
                const float* __restrict__ tap2,
                const float* __restrict__ s, const float* __restrict__ scale,
                const void* __restrict__ bias, int bias_kind,
                OutT* __restrict__ out, int T, int N, long long items) {
  const long long i = (long long)blockIdx.x * kEpiThreads + threadIdx.x;
  if (i >= items) return;
  const int n4 = N >> 2;
  const long long m = i / n4;
  const int c = (int)(i - m * n4) * 4;
  constexpr int kPad = kTaps / 2;
  // the first tap's row in the padded buffer
  const long long base = m + (m / T) * 2 * kPad;
  const float* taps[3] = {tap0, tap1, tap2};
  float y[4];
  {
    const float4 a = ld4(tap0 + base * N + c);
    const float sr = __ldg(s + base);
    y[0] = __fmul_rn(a.x, sr);
    y[1] = __fmul_rn(a.y, sr);
    y[2] = __fmul_rn(a.z, sr);
    y[3] = __fmul_rn(a.w, sr);
  }
#pragma unroll
  for (int j = 1; j < kTaps; ++j) {
    const float4 a = ld4(taps[j] + (base + j) * N + c);
    const float sr = __ldg(s + base + j);
    y[0] = __fadd_rn(y[0], __fmul_rn(a.x, sr));
    y[1] = __fadd_rn(y[1], __fmul_rn(a.y, sr));
    y[2] = __fadd_rn(y[2], __fmul_rn(a.z, sr));
    y[3] = __fadd_rn(y[3], __fmul_rn(a.w, sr));
  }
  const float4 sc = ld4(scale + c);
  y[0] = __fmul_rn(y[0], sc.x);
  y[1] = __fmul_rn(y[1], sc.y);
  y[2] = __fmul_rn(y[2], sc.z);
  y[3] = __fmul_rn(y[3], sc.w);
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias_kind == 1) {
    const float4 b = ld4(static_cast<const float*>(bias) + c);
    bv[0] = b.x, bv[1] = b.y, bv[2] = b.z, bv[3] = b.w;
  } else if (bias_kind == 2) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(bias) + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = __bfloat162float(b[e]);
  }
  OutT* o = out + m * N + c;
  if constexpr (sizeof(OutT) == 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = tt::bf16_round(y[e]);
      if (bias_kind) y[e] = __fadd_rn(y[e], tt::bf16_round(bv[e]));
    }
    *reinterpret_cast<uint2*>(o) =
        make_uint2(tt::pack_bf16(y[0], y[1]), tt::pack_bf16(y[2], y[3]));
  } else {
    if (bias_kind) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = __fadd_rn(y[e], bv[e]);
    }
    *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

template <int kTaps>
void launch_epilogue(const float* tap0, const float* tap1, const float* tap2,
                     const float* s, const float* scale, const void* bias,
                     int bias_kind, void* out, int out_bf16, int T, int N,
                     long long items, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((items + kEpiThreads - 1) / kEpiThreads);
  if (out_bf16)
    e8_epilogue<kTaps, __nv_bfloat16><<<blocks, kEpiThreads, 0, stream>>>(
        tap0, tap1, tap2, s, scale, bias, bias_kind,
        static_cast<__nv_bfloat16*>(out), T, N, items);
  else
    e8_epilogue<kTaps, float><<<blocks, kEpiThreads, 0, stream>>>(
        tap0, tap1, tap2, s, scale, bias, bias_kind,
        static_cast<float*>(out), T, N, items);
}

template <typename X>
void launch_quantize(const void* x, void* codes, float* s, int B, int T,
                     int K, int pad, cudaStream_t stream) {
  const long long rows = (long long)B * (T + 2 * pad);
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const int per_lane = (K / Row<X>::kV + 31) / 32;
  const X* xp = static_cast<const X*>(x);
  __nv_bfloat16* cp = static_cast<__nv_bfloat16*>(codes);
  if (per_lane <= 4)
    q8_rows<X, 4><<<blocks, kRowsPerBlock * 32, 0, stream>>>(xp, cp, s, B, T,
                                                            K, pad);
  else if (per_lane <= 8)
    q8_rows<X, 8><<<blocks, kRowsPerBlock * 32, 0, stream>>>(xp, cp, s, B, T,
                                                            K, pad);
  else
    q8_rows<X, kMaxVec><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
        xp, cp, s, B, T, K, pad);
}

bool misaligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n != 0;
}

}  // namespace

// Kernel Q8. x (B, T, K) contiguous, bf16 (is_f32 = 0) or f32, 16-byte
// aligned, K a multiple of the 16-byte vector (8 bf16, 4 f32) of at most
// 32 kMaxVec vectors. Writes codes (B, T + 2 pad, K) bf16 and s (B, T +
// 2 pad) f32; pad 0 or 1.
TT_EXPORT int tt_int8_quantize_rows(const void* x, int is_f32, void* codes,
                                    float* s, int B, int T, int K, int pad,
                                    cudaStream_t stream) {
  const int V = is_f32 ? 4 : 8;
  if (B < 1 || T < 1 || K < V || K % V || K / V > 32 * kMaxVec || pad < 0 ||
      pad > 1 || misaligned(x, 16) || misaligned(codes, 16) ||
      (long long)B * (T + 2 * pad) > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  if (is_f32)
    launch_quantize<float>(x, codes, s, B, T, K, pad, stream);
  else
    launch_quantize<__nv_bfloat16>(x, codes, s, B, T, K, pad, stream);
  return (int)cudaGetLastError();
}

// Kernel E8. tap0..tap2: the GEMM's f32 sums, (B (T + 2 pad), N)
// contiguous each (tap1, tap2 null for pad 0); s (B (T + 2 pad)) f32 from
// Q8; scale (N) f32; bias (N) f32 (bias_kind 1), bf16 (2) or null (0);
// out (B T, N) bf16 (out_bf16) or f32. N a multiple of 4; every
// pointer read or written in 16 bytes 16-byte aligned (8 for a bf16 out).
TT_EXPORT int tt_int8_epilogue(const float* tap0, const float* tap1,
                               const float* tap2, const float* s,
                               const float* scale, const void* bias,
                               int bias_kind, void* out, int out_bf16, int B,
                               int T, int N, int pad, cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 4 || N % 4 || pad < 0 || pad > 1 ||
      bias_kind < 0 || bias_kind > 2 || (bias_kind != 0) != (bias != nullptr) ||
      (pad == 1) != (tap1 != nullptr && tap2 != nullptr) ||
      misaligned(tap0, 16) || (tap1 && misaligned(tap1, 16)) ||
      (tap2 && misaligned(tap2, 16)) || misaligned(scale, 16) ||
      (bias_kind == 1 && misaligned(bias, 16)) ||
      misaligned(out, out_bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * T * (N / 4);
  if (pad)
    launch_epilogue<3>(tap0, tap1, tap2, s, scale, bias, bias_kind, out,
                       out_bf16, T, N, items, stream);
  else
    launch_epilogue<1>(tap0, nullptr, nullptr, s, scale, bias, bias_kind, out,
                       out_bf16, T, N, items, stream);
  return (int)cudaGetLastError();
}
