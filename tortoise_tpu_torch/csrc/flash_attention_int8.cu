// Kernel F: packed-qkv attention with int8 scores and int8 P@V.
//
// Replaces scripts/ubench_attn_int8_ab.py::flash_packed_i8 (body
// _kernel_packed_i8), the int8-score variant of kernel B that the JAX
// package's A/B holds against flash_attention_packed. Over the denoiser's
// per-head-interleaved qkv (c = h*3D + part*D + d), padded to Tp, a
// multiple of 128 rows (padded keys are masked):
//   sk, sv = max(max|k|, max|v| over the (b, h) / 127, 1e-20), the
//            division a multiply by f32(1/127) as XLA compiles it
//   sq     = the same over each 128-row query block of (b, h)
//   ki, vi, q8 = round(x / s) as int8 (half to even, like jnp.round)
//   s   = (q8 . ki as int32) * (sq * sk * D^-1/2) + bias[h, j - i] + mask[b, j]
//   p   = exp(s - max_j s), l = sum_j p (f32, from the unquantized p)
//   out = (round(127 p) . vi as int32) * (sv / 127) / l
// in the natural-exp domain (the Pallas kernel's log2(e) folding is a
// TPU workaround). The 128-row query block is part of the function: sq is
// one per block of 128 rows.
//
// Two launches. The TPU kernel quantizes K and V once per (batch row,
// head group) at its first grid step into VMEM that later steps reuse;
// blocks on the card run in no order, so that carry becomes a pass of its
// own: quant_kv, one block per (part, h, b), an absmax reduction, then
// the int8 write. It lays out what the attention kernel's mma.sync
// operands read contiguously: ki (B, H, Tp, D) and vi transposed,
// (B, H, D, Tp), with the keys of every 32-key chunk permuted (below).
//
// attn_i8: one block of 8 warps per (b, h, 128-row query block), 16 query
// rows a warp, keys in 64-key shared-memory tiles, products on
// mma.sync.m16n8k32 s8 x s8 -> s32. The softmax cannot be online:
// round(127 p) needs the row's final max, and rescaling a running sum of
// rounded weights computes another function. So the keys are walked
// twice: pass 1 computes the full scores and keeps only the row max;
// pass 2 recomputes them, sums p into l in f32 and round(127 p) . vi in
// exact int32 (a score is at most D * 127^2, a context sum Tp * 127^2,
// both under 2^31 at the shapes the wrapper takes).
//
// The fragment layouts: the s32 score accumulator of m16n8k32 gives a
// thread keys 2*tig and 2*tig + 1 of each 8-key n-tile (tig = lane % 4),
// while the s8 A fragment of the P@V product wants keys 4*tig .. 4*tig + 3
// of a 32-key chunk in one register. Instead of staging p through shared
// memory, quant_kv permutes vi's keys within each 32-key chunk so that
// position kappa = 16*hf + 4*t + e holds key 8*(2*hf + e/2) + 2*t + e%2:
// then a thread's own four n-tiles of scores pack straight into its A
// registers, and the reduction over keys is unchanged.
//
// What bounds the function on an H100, at the A/B's (2, 2176) x 16 x 64:
// the 151.5 M exps on the MUFU (0.036 ms), over the 38.8 G int8
// operations of q . k and p . v (0.020 ms at 1,979 TOPS) and the ~36 MB
// of qkv and output (0.011 ms). This design adds a second score pass and
// the int8 K/V round trip through memory. It is the simple design: no
// pipelining of the tile loads, plain mma.sync (wgmma would reach the
// int8 peak).
#include "common.cuh"

namespace {

constexpr int kBQ = 128;      // query rows of a block (the Q scale's block)
constexpr int kWarps = 8;     // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;       // keys of a shared-memory tile
constexpr int kPad = 16;      // bytes past each int8 row: spreads the banks
constexpr int kQuantThreads = 1024;

struct QuantArgs {
  const void* qkv;   // (B, T, 3*H*D)
  int8_t* ki;        // (B, H, Tp, D)
  int8_t* vit;       // (B, H, D, Tp), keys permuted in 32-key chunks
  float* scales;     // (B, H, 2): sk, sv
  int T, Tp, H;
};

struct AttnArgs {
  const void* qkv;
  const int8_t* ki;
  const int8_t* vit;
  const float* scales;
  const float* bias;  // (H, 2*Tp - 1) Toeplitz: bias[h, (j - i) + Tp - 1]
  const float* mask;  // (B, Tp) additive, padded keys -1e30
  void* out;          // (B, T, H*D), qkv's dtype
  int T, Tp, H;
  float scale;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tt::pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// XLA compiles the Pallas kernel's "/ 127.0" as a multiply by f32(1/127)
constexpr float kInv127 = 1.f / 127.f;

// round(x / s) half to even, saturated to int8 as XLA's convert saturates
__device__ __forceinline__ int quant(float x, float s) {
  return max(-128, min(127, __float2int_rn(x / s)));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ uint2 quant8(const float v[8], float s) {
  return make_uint2(
      pack4(quant(v[0], s), quant(v[1], s), quant(v[2], s), quant(v[3], s)),
      pack4(quant(v[4], s), quant(v[5], s), quant(v[6], s), quant(v[7], s)));
}

// (c * sc + bias) + mask rounded at each step, as the plain version
// adds them (no contraction into an FMA)
__device__ __forceinline__ float score(int c, float sc, float bias,
                                       float mask) {
  return __fadd_rn(__fadd_rn(__fmul_rn((float)c, sc), bias), mask);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x32 row-major s8) * b (32x8 column-major s8), s32 sums
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// position of key j (0..63 of a 64-key tile) in vi's permuted order: the
// inverse of kappa -> 8*(2*hf + e/2) + 2*t + e%2 within each 32-key chunk
__device__ __forceinline__ int key_slot(int j) {
  const int jj = j & 31, nt = jj >> 3, w = jj & 7;
  return (j & 32) + 16 * (nt >> 1) + 4 * (w >> 1) + ((nt & 1) << 1) + (w & 1);
}

// blockIdx (part, h, b): part 0 quantizes K into ki, part 1 V into vit
template <int D, typename T>
__global__ void __launch_bounds__(kQuantThreads) quant_kv(const QuantArgs a) {
  constexpr int kVP = kBK + kPad;
  constexpr int kC = D / 8;  // 8-element chunks of a row
  __shared__ float red[32];
  __shared__ __align__(16) int8_t tile[D * kVP];
  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, T_ = a.T, Tp = a.Tp;
  const size_t row = (size_t)3 * a.H * D;
  const size_t bh = (size_t)b * a.H + h;
  const T* src = static_cast<const T*>(a.qkv) + (size_t)b * T_ * row +
                 (size_t)h * 3 * D + (size_t)(1 + part) * D;
  float v[8], amax = 0.f;
  for (int idx = tid; idx < T_ * kC; idx += kQuantThreads) {
    load8(src + (size_t)(idx / kC) * row + (idx % kC) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = tt::block_max(amax, red);
  const float s = fmaxf(amax * kInv127, 1e-20f);
  if (tid == 0) a.scales[bh * 2 + part] = s;
  if (part == 0) {
    int8_t* dst = a.ki + bh * Tp * D;
    for (int idx = tid; idx < Tp * kC; idx += kQuantThreads) {
      const int t = idx / kC, d0 = (idx % kC) * 8;
      if (t < T_) {
        load8(src + (size_t)t * row + d0, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      *reinterpret_cast<uint2*>(dst + (size_t)t * D + d0) = quant8(v, s);
    }
    return;
  }
  int8_t* dst = a.vit + bh * D * Tp;
  for (int c0 = 0; c0 < Tp; c0 += kBK) {
    for (int idx = tid; idx < kBK * kC; idx += kQuantThreads) {
      const int j = idx / kC, d0 = (idx % kC) * 8, slot = key_slot(j);
      if (c0 + j < T_) {
        load8(src + (size_t)(c0 + j) * row + d0, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tile[(d0 + e) * kVP + slot] = (int8_t)quant(v[e], s);
    }
    __syncthreads();
    for (int w = tid; w < D * (kBK / 4); w += kQuantThreads) {
      const int d = w / (kBK / 4), m = w % (kBK / 4);
      *reinterpret_cast<uint32_t*>(dst + (size_t)d * Tp + c0 + 4 * m) =
          ld32(tile + d * kVP + 4 * m);
    }
    __syncthreads();
  }
}

template <int D>
__host__ __device__ constexpr int int8_smem_bytes() {
  return kBQ * (D + kPad) + kBK * (D + kPad) + D * (kBK + kPad);
}

// dynamic shared memory of an attention block: q8, the K and V tiles,
// the block's bias window (Tp + kBQ floats), the key mask and the
// reduction scratch
template <int D>
size_t attn_smem_bytes(int Tp) {
  return int8_smem_bytes<D>() + 4 * ((size_t)(Tp + kBQ) + Tp + 32);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) attn_i8(const AttnArgs a) {
  constexpr int kQP = D + kPad;    // q8 and K tile row pitch (bytes)
  constexpr int kVP = kBK + kPad;  // V tile row pitch (keys)
  constexpr int kKS = D / 32;      // k-steps of the score product
  constexpr int kND = D / 8;       // n-tiles of the P@V product
  constexpr int kC = D / 8;        // 8-element chunks of a row
  constexpr int kQC = kBQ * kC / kThreads;  // q chunks a thread
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* q8 = reinterpret_cast<int8_t*>(smem);
  int8_t* kt = q8 + kBQ * kQP;
  int8_t* vt = kt + kBK * kQP;
  const int Tp = a.Tp, T_ = a.T, H = a.H;
  float* bias = reinterpret_cast<float*>(smem + int8_smem_bytes<D>());
  float* mask = bias + Tp + kBQ;
  float* red = mask + Tp;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t bh = (size_t)b * H + h;

  // bias[u] = bias(q0 + r, j) at u = j - r + kBQ - 1; the key mask
  const float* bsrc =
      a.bias + (size_t)h * (2 * Tp - 1) + (Tp - 1 - q0 - (kBQ - 1));
  for (int u = tid; u < Tp + kBQ - 1; u += kThreads) bias[u] = bsrc[u];
  for (int j = tid; j < Tp; j += kThreads) mask[j] = a.mask[(size_t)b * Tp + j];

  // the block's queries: their absmax, then int8 into shared memory
  const size_t row = (size_t)3 * H * D;
  const T* qsrc = static_cast<const T*>(a.qkv) + (size_t)b * T_ * row +
                  (size_t)h * 3 * D;
  float qv[kQC][8];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kQC; ++c) {
    const int idx = tid + c * kThreads, t = q0 + idx / kC;
    if (t < T_) {
      load8(qsrc + (size_t)t * row + (idx % kC) * 8, qv[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(qv[c][e]));
  }
  amax = tt::block_max(amax, red);
  const float sq = fmaxf(amax * kInv127, 1e-20f);
#pragma unroll
  for (int c = 0; c < kQC; ++c) {
    const int idx = tid + c * kThreads;
    *reinterpret_cast<uint2*>(q8 + (idx / kC) * kQP + (idx % kC) * 8) =
        quant8(qv[c], sq);
  }
  __syncthreads();
  const int ra = warp * 16 + g, rb = ra + 8;  // the thread's rows
  uint32_t qa[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const int col = ks * 32 + tig * 4;
    qa[ks][0] = ld32(q8 + ra * kQP + col);
    qa[ks][1] = ld32(q8 + rb * kQP + col);
    qa[ks][2] = ld32(q8 + ra * kQP + col + 16);
    qa[ks][3] = ld32(q8 + rb * kQP + col + 16);
  }
  const float sc = sq * a.scales[bh * 2] * a.scale;
  const float sv = a.scales[bh * 2 + 1];
  const int8_t* kb = a.ki + bh * Tp * D;
  const int8_t* vb = a.vit + bh * D * Tp;

  auto load_k = [&](int k0) {
    for (int c = tid; c < kBK * D / 16; c += kThreads) {
      const int r = c / (D / 16), c16 = c % (D / 16);
      *reinterpret_cast<uint4*>(kt + r * kQP + c16 * 16) =
          *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * D +
                                          c16 * 16);
    }
  };
  // the scores of n-tile nt of the tile at k0: keys j, j + 1 of rows
  // ra (s[0], s[1]) and rb (s[2], s[3])
  auto tile_scores = [&](int k0, int nt, float s[4]) {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int8_t* p = kt + (nt * 8 + g) * kQP + ks * 32 + tig * 4;
      mma_s8(c, qa[ks], ld32(p), ld32(p + 16));
    }
    const int j = k0 + nt * 8 + 2 * tig;
    s[0] = score(c[0], sc, bias[j - ra + kBQ - 1], mask[j]);
    s[1] = score(c[1], sc, bias[j + 1 - ra + kBQ - 1], mask[j + 1]);
    s[2] = score(c[2], sc, bias[j - rb + kBQ - 1], mask[j]);
    s[3] = score(c[3], sc, bias[j + 1 - rb + kBQ - 1], mask[j + 1]);
  };

  // pass 1: the row max over every key
  float ma = -INFINITY, mb = -INFINITY;
  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float s[4];
      tile_scores(k0, nt, s);
      ma = fmaxf(ma, fmaxf(s[0], s[1]));
      mb = fmaxf(mb, fmaxf(s[2], s[3]));
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }

  // pass 2: p, l and round(127 p) . vi
  float la = 0.f, lb = 0.f;
  int acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
  for (int k0 = 0; k0 < Tp; k0 += kBK) {
    __syncthreads();
    load_k(k0);
    for (int c = tid; c < D * kBK / 16; c += kThreads) {
      const int d = c / (kBK / 16), c16 = c % (kBK / 16);
      *reinterpret_cast<uint4*>(vt + d * kVP + c16 * 16) =
          *reinterpret_cast<const uint4*>(vb + (size_t)d * Tp + k0 +
                                          c16 * 16);
    }
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kBK / 32; ++ch) {
      int p8[4][4];  // the chunk's four n-tiles x (ra j, ra j+1, rb j, rb j+1)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s[4];
        tile_scores(k0, ch * 4 + q, s);
        const float pa0 = expf(s[0] - ma), pa1 = expf(s[1] - ma);
        const float pb0 = expf(s[2] - mb), pb1 = expf(s[3] - mb);
        la += pa0 + pa1;
        lb += pb0 + pb1;
        p8[q][0] = __float2int_rn(pa0 * 127.f);
        p8[q][1] = __float2int_rn(pa1 * 127.f);
        p8[q][2] = __float2int_rn(pb0 * 127.f);
        p8[q][3] = __float2int_rn(pb1 * 127.f);
      }
      // A fragment of keys kappa = 4*tig + e (regs 0, 1) and 16 + 4*tig +
      // e (regs 2, 3) in vi's permuted order
      const uint32_t pa[4] = {
          pack4(p8[0][0], p8[0][1], p8[1][0], p8[1][1]),
          pack4(p8[0][2], p8[0][3], p8[1][2], p8[1][3]),
          pack4(p8[2][0], p8[2][1], p8[3][0], p8[3][1]),
          pack4(p8[2][2], p8[2][3], p8[3][2], p8[3][3])};
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        const int8_t* p = vt + (n * 8 + g) * kVP + ch * 32 + tig * 4;
        mma_s8(acc[n], pa, ld32(p), ld32(p + 16));
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }
  const float dq = sv * kInv127;
  const float ia = fmaxf(la, 1e-30f), ib = fmaxf(lb, 1e-30f);
  T* out = static_cast<T*>(a.out);
  const size_t orow = (size_t)H * D;
  const int ta = q0 + ra, tb = q0 + rb;
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int d = h * D + n * 8 + 2 * tig;
    if (ta < T_)
      store2(out + ((size_t)b * T_ + ta) * orow + d,
             (float)acc[n][0] * dq / ia, (float)acc[n][1] * dq / ia);
    if (tb < T_)
      store2(out + ((size_t)b * T_ + tb) * orow + d,
             (float)acc[n][2] * dq / ib, (float)acc[n][3] * dq / ib);
  }
}

template <int D, typename T>
int launch_quant(const QuantArgs& a, int B, cudaStream_t stream) {
  quant_kv<D, T><<<dim3(2, a.H, B), kQuantThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_attn(const AttnArgs& a, int B, cudaStream_t stream) {
  static tt::KernelFacts facts;
  const size_t smem = attn_smem_bytes<D>(a.Tp);
  const cudaError_t err =
      facts.allow_smem(reinterpret_cast<const void*>(attn_i8<D, T>));
  if (err != cudaSuccess) return (int)err;
  attn_i8<D, T><<<dim3(a.Tp / kBQ, a.H, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int quant_by_width(const QuantArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_quant<32, T>(a, B, stream);
    case 64: return launch_quant<64, T>(a, B, stream);
    case 128: return launch_quant<128, T>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int attn_by_width(const AttnArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_attn<32, T>(a, B, stream);
    case 64: return launch_attn<64, T>(a, B, stream);
    case 128: return launch_attn<128, T>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int T, int Tp, int H) {
  return B < 1 || H < 1 || T < 1 || Tp < T || Tp % kBQ || B > 65535 ||
         H > 65535;
}

}  // namespace

// Kernel F's quantize pass. qkv (B, T, 3*H*D) bf16 (is_f32 = 0) or f32,
// per-head interleaved, 16-byte aligned; writes ki (B, H, Tp, D) int8,
// vit (B, H, D, Tp) int8 with the keys permuted in 32-key chunks, and
// scales (B, H, 2) f32 (sk, sv). Tp is T padded to a multiple of 128;
// rows past T quantize as zeros. D in {32, 64, 128}.
TT_EXPORT int tt_int8_quantize_kv(const void* qkv, int is_f32, int B, int T,
                                  int Tp, int H, int D, void* ki, void* vit,
                                  float* scales, cudaStream_t stream) {
  if (bad_shape(B, T, Tp, H)) return (int)cudaErrorInvalidValue;
  const QuantArgs a{qkv, static_cast<int8_t*>(ki), static_cast<int8_t*>(vit),
                    scales, T, Tp, H};
  return is_f32 ? quant_by_width<float>(a, B, D, stream)
                : quant_by_width<__nv_bfloat16>(a, B, D, stream);
}

// Kernel F's attention. qkv as for tt_int8_quantize_kv, ki, vit and scales
// as it wrote them; bias (H, 2*Tp - 1) f32 Toeplitz, mask (B, Tp) f32
// additive (padded keys -1e30); out (B, T, H*D) in qkv's dtype.
TT_EXPORT int tt_flash_packed_i8(const void* qkv, int is_f32, const void* ki,
                                 const void* vit, const float* scales,
                                 const float* bias, const float* mask, int B,
                                 int T, int Tp, int H, int D, float scale,
                                 void* out, cudaStream_t stream) {
  if (bad_shape(B, T, Tp, H)) return (int)cudaErrorInvalidValue;
  const AttnArgs a{qkv, static_cast<const int8_t*>(ki),
                   static_cast<const int8_t*>(vit), scales, bias, mask, out,
                   T, Tp, H, scale};
  return is_f32 ? attn_by_width<float>(a, B, D, stream)
                : attn_by_width<__nv_bfloat16>(a, B, D, stream);
}
