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
// What bounds the function on an H100, at the A/B's (2, 2176) x 16 x 64:
// the 151.5 M exps on the MUFU (0.036 ms), over the 38.8 G int8
// operations of q . k and p . v (0.020 ms at 1,979 TOPS) and the ~36 MB
// of qkv and output (0.011 ms). This design adds a second score pass
// (another 9.7 G int8 operations) and computes each p with expf, whose
// polynomial runs on the FMA pipe: round(127 p) is a step function, so p
// must be the bits torch.exp gives on the card (ex2.approx would flip
// weights), and the scores take the plain version's roundings (no FMA
// contraction).
//
// Two launches.
//
// quant_kv, the quantize pass: the TPU kernel quantizes K and V once per
// (batch row, head group) at its first grid step into VMEM that later
// steps reuse; blocks on the card run in no order, so that carry becomes
// a pass of its own. One 8-block cluster per (b, h, part), 512 blocks at
// the A/B's shape: each block takes every 8th 64-row tile, reduces its
// absmax, and the cluster combines the eight through distributed shared
// memory (no second launch, no atomics), then each block quantizes its
// tiles (a second read, of K and V that fit the 50 MB L2 at the A/B's
// shape, 8.9 MB). It writes what the attention
// kernel's tensor maps read: ki (B, H, Tp, D) and vi transposed, (B, H,
// D, Tp), keys of every 32-key chunk permuted (below).
//
// attn_i8: one block per (b, h, 128-row query block), the Q scale's
// block: two consumer warpgroups of 64 rows and a producer warp, as
// kernel B's body (flash_attention.cu). The block quantizes its queries
// straight into wgmma A fragments in registers (a consumer-only named
// barrier for the block's absmax). The producer streams, per 64-key tile,
// the ki tile (64 keys x D, TMA, D-byte swizzle), in pass 2 also the vit
// tile (D x 64 keys, TMA, 64-byte swizzle), and the tile's bias window
// (the 192 deltas j - i the block's rows see: bias is (H, 2 Tp) at
// delta + Tp, so the window starts 16-byte aligned) and key mask (bulk
// copies) into a 4-stage ring under full/empty mbarriers; nothing is
// staged per Tp, so Tp is bounded only by exact int32 sums (Tp * 127^2 <
// 2^31). S = Q K^T is wgmma.m64nNk32.s32.s8.s8 (A = q8 from registers,
// B = the ki tile, K-major); O += P V is wgmma.m64nDk32 with A = round(127
// p) from registers and B = the vit tile (keys contiguous: K-major, as
// 8-bit wgmma requires of both operands). Two blocks of 288 threads an SM
// (at widths 32 and 64) leave a thread 96 registers: the sub-partition
// holding five warps sets the cap. At width 64 the two int32 accumulators
// of a 64-key tile (S and O, 32 registers each) and q8 left ptxas too few
// for the wgmma pipeline (it serialized the wgmmas and spilled), so pass 2
// takes each tile in two 32-key halves: S of the half (m64n32, 16
// registers), its weights, its P V step.
//
// The softmax cannot be online: round(127 p) needs the row's final max,
// and rescaling a running sum of rounded weights computes another
// function. So the keys are walked twice. Pass 1 keeps only the row max.
// Where a warp's 16 rows see one bias value over the whole tile and every
// key of it is valid (all tiles beyond the T5 band, checked on the staged
// values, not assumed), the scores of a row are monotone in the int32
// product, so the max is taken on the accumulator and scaled once. Pass 2
// recomputes the scores (on such tiles without the bias and mask reads),
// sums p into l in f32 and round(127 p) . vi in exact int32 (a score is
// at most D * 127^2, a context sum Tp * 127^2). A ring wait that never
// completes traps after 10 s (a launch error, not a hung card).
// The int32 -> f32 conversion of a score and round(127 p) use the 1.5 *
// 2^23 magic number (exact below 2^22; the conversion units run at 16 a
// clock an SM).
//
// The fragment layouts: wgmma's s32 accumulator gives a thread keys 2t and
// 2t + 1 of each 8-key column group (t = lane % 4, rows g and g + 8 of
// its warp's 16), while the register A fragment of a k32 8-bit wgmma is,
// warp by warp, mma.m16n8k32's: keys 4t .. 4t + 3 of a 32-key step in
// one register. That is the mismatch the earlier mma.sync design had, so the
// same cure holds: quant_kv permutes vi's keys within each 32-key chunk
// so that position kappa = 16*hf + 4*t + e holds key 8*(2*hf + e/2) + 2*t
// + e%2; a thread's own four column groups of scores then pack straight
// into its A registers, and the reduction over keys is unchanged.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBQ = 128;           // query rows of a block (the Q scale's block)
constexpr int kBK = 64;            // keys of a tile
constexpr int kStages = 4;         // ring depth
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kWin = kBQ + kBK;    // bias floats a tile: deltas j - i seen
constexpr int kSideBytes = 4 * (kWin + kBK);  // bias window + key mask
constexpr int kPad = 16;           // bytes past each row of quant_kv's tile
constexpr int kCluster = 8;        // quant_kv blocks a (b, h, part)
constexpr int kQuantThreads = 256;
// the longest padded length whose context sums stay exact in int32
constexpr int kMaxTp = 133120;     // 128 * floor(2^31 / 127^2 / 128)

struct QuantArgs {
  const void* qkv;   // (B, T, 3*H*D)
  int8_t* ki;        // (B, H, Tp, D)
  int8_t* vit;       // (B, H, D, Tp), keys permuted in 32-key chunks
  float* scales;     // (B, H, 2): sk, sv
  int T, Tp, H;
};

struct AttnArgs {
  const void* qkv;
  const float* scales;
  const float* bias;  // (H, 2*Tp): bias[h, (j - i) + Tp]; column 0 unused
  const float* mask;  // (B, Tp) additive, padded keys -1e30
  void* out;          // (B, T, H*D), qkv's dtype
  int T, Tp, H;
  float scale;
};

template <int D>
struct Geo {
  static_assert(D == 32 || D == 64 || D == 128, "head width 32, 64 or 128");
  static constexpr int kKBytes = kBK * D;  // ki tile: 64 keys of D bytes
  static constexpr int kVBytes = D * kBK;  // vit tile: D rows of 64 keys
  static constexpr int kOffV = kKBytes;
  static constexpr int kOffSide = kKBytes + kVBytes;
  static constexpr int kStageBytes = kOffSide + kSideBytes;  // x 1024
  static constexpr int kOffBar = kStages * kStageBytes;
  static constexpr int kOffRed = kOffBar + 2 * kStages * 8;
  static constexpr size_t kSmem = 1024 + kOffRed + 32;  // + align slack
  static constexpr int kMinBlocks = D > 64 ? 1 : 2;   // per SM (registers)
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

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
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

// 1.5 * 2^23: adding it rounds a float in (-2^22, 2^22) to an integer
// (half to even) in the low mantissa bits; adding an int to its bits and
// subtracting it converts the int to float, exactly
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float int_to_float(int c) {
  return __fsub_rn(__int_as_float(kMagicBits + c), kMagic);
}

// (c * sc + bias) + mask rounded at each step, as the plain version
// adds them (no contraction into an FMA)
__device__ __forceinline__ float score(int c, float sc, float bias,
                                       float mask) {
  return __fadd_rn(__fadd_rn(__fmul_rn(int_to_float(c), sc), bias), mask);
}

// round(127 p) for p in [0, 1], as the low byte of the magic sum's bits
__device__ __forceinline__ uint32_t p8_bits(float p) {
  return __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic));
}

// the low bytes of a, b, c, d as one register (a lowest)
__device__ __forceinline__ uint32_t pack_low(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// mbarrier wait that traps (a launch failure the wrapper reports) instead
// of spinning forever if a phase never completes, e.g. a tile load that
// never lands: 10 s on the global timer, read every 1024 tries
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (unsigned n = 0; !done; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tt::smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && (n & 1023) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (n == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// position of key j (0..63 of a 64-key tile) in vi's permuted order: the
// inverse of kappa -> 8*(2*hf + e/2) + 2*t + e%2 within each 32-key chunk
__device__ __forceinline__ int key_slot(int j) {
  const int jj = j & 31, nt = jj >> 3, w = jj & 7;
  return (j & 32) + 16 * (nt >> 1) + 4 * (w >> 1) + ((nt & 1) << 1) + (w & 1);
}

// blockIdx (rank in the cluster, part, b * H + h): part 0 quantizes K
// into ki, part 1 V into vit; the cluster's 8 blocks share one scale
template <int D, typename T>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kQuantThreads) quant_kv(const QuantArgs a) {
  constexpr int kVP = kBK + kPad;
  constexpr int kC = D / 8;  // 8-element chunks of a row
  __shared__ float red[32];
  __shared__ float block_amax;  // read by the whole cluster
  __shared__ __align__(16) int8_t tile[D * kVP];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, part = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, T_ = a.T, Tp = a.Tp;
  const size_t row = (size_t)3 * a.H * D;
  const T* src = static_cast<const T*>(a.qkv) + (size_t)b * T_ * row +
                 (size_t)h * 3 * D + (size_t)(1 + part) * D;
  float v[8], amax = 0.f;
  for (int t0 = rank * kBK; t0 < Tp; t0 += kCluster * kBK)
    for (int idx = tid; idx < kBK * kC; idx += kQuantThreads) {
      const int t = t0 + idx / kC;
      if (t < T_) {
        load8(src + (size_t)t * row + (idx % kC) * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
      }
    }
  amax = tt::block_max(amax, red);
  if (tid == 0) block_amax = amax;
  cluster.sync();
#pragma unroll
  for (int r = 0; r < kCluster; ++r)
    amax = fmaxf(amax, *cluster.map_shared_rank(&block_amax, r));
  cluster.sync();  // no block leaves while another reads its block_amax
  const float s = fmaxf(amax * kInv127, 1e-20f);
  if (rank == 0 && tid == 0) a.scales[bh * 2 + part] = s;
  if (part == 0) {
    int8_t* dst = a.ki + (size_t)bh * Tp * D;
    for (int t0 = rank * kBK; t0 < Tp; t0 += kCluster * kBK)
      for (int idx = tid; idx < kBK * kC; idx += kQuantThreads) {
        const int t = t0 + idx / kC, d0 = (idx % kC) * 8;
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
  int8_t* dst = a.vit + (size_t)bh * D * Tp;
  for (int c0 = rank * kBK; c0 < Tp; c0 += kCluster * kBK) {
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

#define TT_I8(d, o)                                                          \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),            \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
#define TT_I16(d, o) TT_I8(d, o), TT_I8(d, o + 8)
#define TT_I32(d, o) TT_I16(d, o), TT_I16(d, o + 16)
#define TT_R16                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TT_R32                                                               \
  TT_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
         "%28, %29, %30, %31"
#define TT_R64                                                               \
  TT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
         "%57, %58, %59, %60, %61, %62, %63"

// d (+)= A (registers, 64 x 32 s8) * B (smem, K-major s8), s32 sums, for
// N = 32, 64 and 128 columns (16, 32, 64 accumulator registers)
__device__ __forceinline__ void wgmma_i8(int (&d)[16], const uint32_t a[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" TT_R16
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : TT_I16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_i8(int (&d)[32], const uint32_t a[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" TT_R32
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : TT_I32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_i8(int (&d)[64], const uint32_t a[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" TT_R64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : TT_I32(d, 0), TT_I32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S = Q K^T of a warpgroup's 64 rows and one 64-key tile: D/32 k-steps of
// 32 bytes along the ki tile's rows
template <int D>
__device__ __forceinline__ void score_tile(int (&s)[32],
                                           const uint32_t (&qa)[D / 32][4],
                                           const uint8_t* kt) {
  const uint64_t dk = tt::wgmma_desc<D>(kt);
  tt::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks) wgmma_i8(s, qa[ks], dk + 2 * ks, ks);
  tt::wgmma_commit();
  tt::wgmma_wait<0>();
  tt::fence_regs(s);
}

// the block's queries of rows i0 .. i0 + 127 of one (b, h), quantized on
// their block's absmax straight into this thread's wgmma A fragments:
// qa[ks][r] holds row ra (r even) or ra + 8 (r odd), columns 32 ks + 4 t
// + 16 (r / 2) .. + 3. red: 8 floats.
template <int D, typename T>
__device__ __forceinline__ float quantize_q(uint32_t (&qa)[D / 32][4],
                                            const T* qrow, size_t row,
                                            int i0, int ra, int t4, int T_,
                                            float* red) {
  float qv[D / 32][4][4];
  float amax = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = i0 + ra + 8 * (r & 1);
      const int col = 32 * ks + 4 * t4 + 16 * (r >> 1);
      if (t < T_) {
        load4(qrow + (size_t)t * row + col, qv[ks][r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[ks][r][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(qv[ks][r][e]));
    }
  amax = tt::warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float sq = fmaxf(amax * kInv127, 1e-20f);
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      qa[ks][r] = pack4(quant(qv[ks][r][0], sq), quant(qv[ks][r][1], sq),
                        quant(qv[ks][r][2], sq), quant(qv[ks][r][3], sq));
  return sq;
}

// True (the same on every lane) when the tile's window holds one bias
// value b0 over the warp's 16 rows and 64 keys (window indices lo .. lo
// + 78) and every key of the tile is valid (mask 0): every tile beyond
// the T5 band, read off the staged values, not assumed. There a score
// is (c sc + b0) + 0, and the + 0 can go: it changes at most the sign of
// a zero, which exp(s - m) does not see.
__device__ __forceinline__ bool uniform_tile(const float* bw,
                                             const float* mk, int lo,
                                             int lane, float& b0) {
  b0 = bw[lo];
  const bool same = bw[lo + lane] == b0 && bw[lo + 32 + lane] == b0 &&
                    (lane >= 15 || bw[lo + 64 + lane] == b0) &&
                    mk[lane] == 0.f && mk[lane + 32] == 0.f;
  return __all_sync(0xffffffffu, same);
}

// Pass 2's weights of one 32-key step: p = exp(s - m) of the thread's
// 16 scores s (the m64n32 accumulator: s[4c + 2hf + e] is row ra + 8 hf,
// key j0 + 8c + 2t + e) into la / lb, and round(127 p) packed as the
// step's A fragment pa (keys in vi's permuted order). kUniform: the
// tile's bias is b0 and its keys are all valid (uniform_tile).
template <bool kUniform>
__device__ __forceinline__ void step_weights(
    const int* s, const float* bw, const float* mk, int xa, int t4, int j0,
    float sc, float b0, float ma, float mb, float& la, float& lb,
    uint32_t (&pa)[4]) {
  uint32_t w[4][4];  // column group q: (ra, key), (ra, key + 1), rb ..
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + 8 * q;
    float v[4];
    if (kUniform) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = __fadd_rn(__fmul_rn(int_to_float(s[4 * q + e]), sc), b0);
    } else {
      const float2 m2 = *reinterpret_cast<const float2*>(mk + j + 2 * t4);
      v[0] = score(s[4 * q], sc, bw[xa + j], m2.x);
      v[1] = score(s[4 * q + 1], sc, bw[xa + j + 1], m2.y);
      v[2] = score(s[4 * q + 2], sc, bw[xa + j - 8], m2.x);
      v[3] = score(s[4 * q + 3], sc, bw[xa + j - 7], m2.y);
    }
    const float pa0 = expf(__fsub_rn(v[0], ma));
    const float pa1 = expf(__fsub_rn(v[1], ma));
    const float pb0 = expf(__fsub_rn(v[2], mb));
    const float pb1 = expf(__fsub_rn(v[3], mb));
    la += pa0 + pa1;
    lb += pb0 + pb1;
    w[q][0] = p8_bits(pa0);
    w[q][1] = p8_bits(pa1);
    w[q][2] = p8_bits(pb0);
    w[q][3] = p8_bits(pb1);
  }
  // keys kappa = 4 t + e (registers 0, 1) and 16 + 4 t + e (2, 3) in vi's
  // permuted order: column groups 0, 1 and 2, 3 of the step
  pa[0] = pack_low(w[0][0], w[0][1], w[1][0], w[1][1]);
  pa[1] = pack_low(w[0][2], w[0][3], w[1][2], w[1][3]);
  pa[2] = pack_low(w[2][0], w[2][1], w[3][0], w[3][1]);
  pa[3] = pack_low(w[2][2], w[2][3], w[3][2], w[3][3]);
}

// S of a warpgroup's 64 rows and keys 32 h .. 32 h + 31 of the tile (the
// ki tile's rows from 32 h: four 8-row swizzle atoms on)
template <int D>
__device__ __forceinline__ void score_half(int (&s)[16],
                                           const uint32_t (&qa)[D / 32][4],
                                           const uint8_t* kt, int h) {
  const uint64_t dk = tt::wgmma_desc<D>(kt) + ((32 * D * h) >> 4);
  tt::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 32; ++ks) wgmma_i8(s, qa[ks], dk + 2 * ks, ks);
  tt::wgmma_commit();
  tt::wgmma_wait<0>();
  tt::fence_regs(s);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, Geo<D>::kMinBlocks)
    attn_i8(const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const AttnArgs a) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tt::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kOffBar);
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(smem + G::kOffRed);
  const int Tp = a.Tp, T_ = a.T, H = a.H;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int tid = threadIdx.x, ntiles = Tp / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tt::mbar_init(&full[s], 1);
      tt::mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane streams tile u (pass 1's ki, bias window
    // and mask for u < ntiles, then pass 2's with vit) into stage u %
    // kStages once all 8 consumer warps have released the tile before
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&kmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&vmap))
                   : "memory");
      const float* bias_h = a.bias + (size_t)h * 2 * Tp + (Tp - kBQ - q0);
      const float* mask_b = a.mask + (size_t)b * Tp;
      for (int u = 0; u < 2 * ntiles; ++u) {
        const int st = u % kStages, n = u / kStages;
        const bool pv = u >= ntiles;
        const int j0 = (pv ? u - ntiles : u) * kBK;
        uint8_t* stage = smem + st * G::kStageBytes;
        if (n > 0) wait_or_trap(&empty[st], (n - 1) & 1);
        tt::mbar_expect_tx(&full[st], G::kKBytes + kSideBytes +
                                          (pv ? G::kVBytes : 0));
        tt::tma_load_3d(stage, &kmap, &full[st], 0, j0, bh);
        if (pv) tt::tma_load_3d(stage + G::kOffV, &vmap, &full[st], j0, 0, bh);
        tt::bulk_load(stage + G::kOffSide, bias_h + j0, 4 * kWin, &full[st]);
        tt::bulk_load(stage + G::kOffSide + 4 * kWin, mask_b + j0, 4 * kBK,
                      &full[st]);
      }
    }
    return;
  }
  // a consumer warp is done with tile u
  auto release = [&](int u) {
    __syncwarp();
    if ((tid & 31) == 0) tt::mbar_arrive(&empty[u % kStages]);
  };

  // warpgroup wg owns block rows 64 wg .. + 63; this thread holds block
  // rows ra and rb = ra + 8 of the accumulators
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = wg * 64 + warp * 16;  // the warp's first block row
  const int ra = wrow + g, rb = ra + 8;
  const size_t row = (size_t)3 * H * D;
  const T* qrow = static_cast<const T*>(a.qkv) + (size_t)b * T_ * row +
                  (size_t)h * 3 * D;
  uint32_t qa[D / 32][4];
  const float sq = quantize_q<D, T>(qa, qrow, row, q0, ra, t4, T_, red);
  const float sc = sq * a.scales[bh * 2] * a.scale;
  const float sv = a.scales[bh * 2 + 1];
  // the window holds bias(row r, key j0 + jj) at jj - r + kBQ
  const int xa = 2 * t4 - ra + kBQ;  // row rb's index is xa - 8
  const int lo = kBQ - wrow - 15;  // the warp's lowest window index

  // pass 1: the row max over every key
  float ma = -INFINITY, mb = -INFINITY;
  for (int u = 0; u < ntiles; ++u) {
    const int st = u % kStages;
    const uint8_t* stage = smem + st * G::kStageBytes;
    const float* bw = reinterpret_cast<const float*>(stage + G::kOffSide);
    const float* mk = bw + kWin;
    wait_or_trap(&full[st], (u / kStages) & 1);
    int s[32];
    score_tile<D>(s, qa, stage);
    float b0;
    if (uniform_tile(bw, mk, lo, lane, b0)) {
      // the max of a row's scores is the score of its largest product
      int ia = s[0], ib = s[2];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        ia = max(ia, max(s[4 * c], s[4 * c + 1]));
        ib = max(ib, max(s[4 * c + 2], s[4 * c + 3]));
      }
      ma = fmaxf(ma, score(ia, sc, b0, 0.f));
      mb = fmaxf(mb, score(ib, sc, b0, 0.f));
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = 8 * c;
        const float2 m2 = *reinterpret_cast<const float2*>(mk + j + 2 * t4);
        ma = fmaxf(ma, fmaxf(score(s[4 * c], sc, bw[xa + j], m2.x),
                             score(s[4 * c + 1], sc, bw[xa + j + 1], m2.y)));
        mb = fmaxf(mb, fmaxf(score(s[4 * c + 2], sc, bw[xa + j - 8], m2.x),
                             score(s[4 * c + 3], sc, bw[xa + j - 7], m2.y)));
      }
    }
    release(u);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }

  // pass 2: p, l and round(127 p) . vi
  float la = 0.f, lb = 0.f;
  int acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0;
  for (int u = ntiles; u < 2 * ntiles; ++u) {
    const int st = u % kStages;
    const uint8_t* stage = smem + st * G::kStageBytes;
    const float* bw = reinterpret_cast<const float*>(stage + G::kOffSide);
    const float* mk = bw + kWin;
    wait_or_trap(&full[st], (u / kStages) & 1);
    float b0;
    const bool uni = uniform_tile(bw, mk, lo, lane, b0);
    const uint64_t dv = tt::wgmma_desc<64>(stage + G::kOffV);
    // the tile in two 32-key halves: S, its weights, its P V step
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      int sh[16];
      score_half<D>(sh, qa, stage, hs);
      uint32_t pa[4];
      if (uni)
        step_weights<true>(sh, bw, mk, xa, t4, 32 * hs, sc, b0, ma, mb, la,
                           lb, pa);
      else
        step_weights<false>(sh, bw, mk, xa, t4, 32 * hs, sc, b0, ma, mb, la,
                            lb, pa);
      tt::fence_regs(acc);
      tt::wgmma_fence();
      wgmma_i8(acc, pa, dv + 2 * hs, 1);
      tt::wgmma_commit();
      tt::wgmma_wait<0>();
      tt::fence_regs(acc);
    }
    release(u);
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
  for (int c = 0; c < D / 8; ++c) {
    const int d = h * D + 8 * c + 2 * t4;
    if (ta < T_)
      store2(out + ((size_t)b * T_ + ta) * orow + d,
             (float)acc[4 * c] * dq / ia, (float)acc[4 * c + 1] * dq / ia);
    if (tb < T_)
      store2(out + ((size_t)b * T_ + tb) * orow + d,
             (float)acc[4 * c + 2] * dq / ib, (float)acc[4 * c + 3] * dq / ib);
  }
}

// A 3-D uint8 tensor map (inner, mid, outer) over a contiguous array, box
// (box0, box1, 1), the swizzle of box0 bytes (32, 64 or 128)
bool encode_u8(CUtensorMap* map, const void* p, int inner, int mid,
               int outer, int box0, int box1) {
  tt::EncodeTiled enc = tt::encode_tiled();
  if (!enc || reinterpret_cast<uintptr_t>(p) % 16) return false;
  const cuuint64_t gd[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                            (cuuint64_t)outer};
  const cuuint64_t gs[2] = {(cuuint64_t)inner,
                            (cuuint64_t)inner * (cuuint64_t)mid};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box0 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box0 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(p), gd,
             gs, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename T>
int launch_quant(const QuantArgs& a, int B, cudaStream_t stream) {
  quant_kv<D, T><<<dim3(kCluster, 2, B * a.H), kQuantThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_attn(const void* ki, const void* vit, const AttnArgs& a, int B,
                cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!encode_u8(&kmap, ki, D, a.Tp, B * a.H, D, kBK) ||
      !encode_u8(&vmap, vit, a.Tp, D, B * a.H, kBK, D))
    return (int)cudaErrorInvalidValue;
  auto* fn = attn_i8<D, T>;
  static tt::KernelFacts facts;
  const cudaError_t err = facts.allow_smem(reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return (int)err;
  fn<<<dim3(a.Tp / kBQ, a.H, B), kThreads, Geo<D>::kSmem, stream>>>(kmap, vmap,
                                                                    a);
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
int attn_by_width(const void* ki, const void* vit, const AttnArgs& a, int B,
                  int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_attn<32, T>(ki, vit, a, B, stream);
    case 64: return launch_attn<64, T>(ki, vit, a, B, stream);
    case 128: return launch_attn<128, T>(ki, vit, a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int T, int Tp, int H) {
  return B < 1 || H < 1 || T < 1 || Tp < T || Tp % kBQ || Tp > kMaxTp ||
         B > 65535 || H > 65535 || (long long)B * H > 65535;
}

}  // namespace

// Kernel F's quantize pass. qkv (B, T, 3*H*D) bf16 (is_f32 = 0) or f32,
// per-head interleaved, 16-byte aligned; writes ki (B, H, Tp, D) int8,
// vit (B, H, D, Tp) int8 with the keys permuted in 32-key chunks, and
// scales (B, H, 2) f32 (sk, sv). Tp is T padded to a multiple of 128, at
// most 133120; rows past T quantize as zeros. D in {32, 64, 128}.
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
// as it wrote them (16-byte aligned); bias (H, 2*Tp) f32, bias[h, (j - i)
// + Tp] (column 0 unused), mask (B, Tp) f32 additive (padded keys -1e30),
// both 16-byte aligned; out (B, T, H*D) in qkv's dtype.
TT_EXPORT int tt_flash_packed_i8(const void* qkv, int is_f32, const void* ki,
                                 const void* vit, const float* scales,
                                 const float* bias, const float* mask, int B,
                                 int T, int Tp, int H, int D, float scale,
                                 void* out, cudaStream_t stream) {
  if (bad_shape(B, T, Tp, H) || reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16)
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{qkv, scales, bias, mask, out, T, Tp, H, scale};
  return is_f32 ? attn_by_width<float>(ki, vit, a, B, D, stream)
                : attn_by_width<__nv_bfloat16>(ki, vit, a, B, D, stream);
}
