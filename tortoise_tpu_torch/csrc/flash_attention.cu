// Exact-softmax attention straight off a fused qkv tensor (kernels B, C).
//
// Replaces tortoise_tpu/ops/pallas/flash_attention.py:
//   B  flash_attention_packed      — non-causal, per-head-interleaved qkv
//      (c = h*3D + part*D + d), T5 rel-pos bias, additive key mask;
//   C  flash_attention_causal_qkv  — causal, part-major qkv
//      (c = part*H*D + h*D + d), additive key mask.
//
// What bounds it on the card: ~4*T*T*D FLOPs per (batch, head) on the
// tensor cores (QK^T and PV) and T*T exps on the MUFU, against a qkv read
// of only T*3*D bf16; at (2, 2176) x 16 heads both take ~0.04 ms.
//
// Design (Hopper, head width 64): one block owns 128 query rows of one
// (batch, head) and walks the keys in 64-key tiles.
// - A producer warp issues TMA loads: the Q tile once, then K and V tiles
//   into a 3-stage shared-memory ring guarded by mbarriers (full: the
//   tile's bytes landed; empty: all 8 consumer warps are done with it).
//   One 3-D tensor map (channels, T, B) over the fused qkv expresses both
//   layouts: a K or V tile is the box at channel offset k_off / v_off,
//   rows j0..j0+63 of batch b, and rows past T read as zeros. The 128-byte
//   swizzle of the TMA box is the layout wgmma reads.
// - Two consumer warpgroups own 64 query rows each. S = Q K^T runs as four
//   wgmma.m64n64k16 with Q and K from shared memory; the online softmax
//   stays in registers; O += P V runs as four wgmma.m64n64k16 with P from
//   registers (the S accumulator's layout is the A-fragment layout) and V
//   from shared memory read MN-major (the B-operand transpose).
// - The per-head Toeplitz bias window (the T + 191 deltas j - i this
//   block can see) and the additive key mask are staged once per block.
// - C's blocks stop at their diagonal: tiles above it are never loaded,
//   and a warpgroup skips the last tile when all its rows precede it.
//
// Numerics follow the Pallas kernels: bf16 q/k/v, f32 scores, the
// softmax weights rounded to bf16 before the PV product, f32 normaliser
// summed from the unrounded weights, output rounded to bf16. The score
// scale 1/sqrt(64) is a power of two, so scaling the f32 score equals
// scaling q. The softmax runs in base 2 on the MUFU (scores times
// log2 e, then ex2), which is e^x to within its rounding. The bias arrives as a per-head Toeplitz vector
// bias[h, (j - i) + T - 1] (the bucket ids depend only on j - i); the
// mask as an additive 0 / -1e30 row per batch row.
#include "common.cuh"

namespace {

constexpr int kD = 64;             // head width the kernels are built for
constexpr int kBQ = 128;           // query rows per block (2 warpgroups)
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 3;         // K/V ring depth
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTile = kBK * kD;    // bf16 elements of one 64 x 64 tile
constexpr unsigned kTileBytes = kTile * 2;

// shared-memory layout (offsets from a 1024-byte aligned base)
constexpr int kOffQ = 0;                           // 2 x 64 query rows
constexpr int kOffK = kOffQ + 2 * kTile * 2;       // kStages K tiles
constexpr int kOffV = kOffK + kStages * kTile * 2; // kStages V tiles
constexpr int kOffBar = kOffV + kStages * kTile * 2;
constexpr int kOffF32 = kOffBar + 128;             // bias window, mask

// wgmma shared-memory descriptor of a 1024-byte aligned tile of 64-element
// (128-byte) rows in the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = tt::smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the async ops
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TT_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define TT_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A (smem, K-major) * B (smem, K-major), 64 x 64 x 16
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (registers) * B (smem, MN-major: the transposed B operand)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t a[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

using tt::pack_bf16;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU (scores are kept in log2 units: e^s = 2^(s log2 e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
attn_kernel(const __grid_constant__ CUtensorMap qkv_map, int T, int H,
            int q_off, int k_off, int v_off, int head_stride,
            const float* __restrict__ bias,
            const float* __restrict__ mask, float scale,
            __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tt::smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + kOffQ);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + kOffK);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + kOffV);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int tpad = (T + kBK - 1) / kBK * kBK;
  float* bs = reinterpret_cast<float*>(smem + kOffF32);  // tpad + kBQ
  float* ms = bs + tpad + kBQ;                           // tpad

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hc = h * head_stride;  // this head's channel offset
  const int i0 = qt * kBQ;
  const int kend = kCausal ? min(T, i0 + kBQ) : T;
  const int ntiles = (kend + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tt::mbar_init(&full[s], 1);
      tt::mbar_init(&empty[s], kConsumers / 32);
    }
    tt::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the bias of delta = j - i sits at bs[delta + i0 + kBQ - 1]
  const float* bias_h = bias ? bias + (size_t)h * (2 * T - 1) : nullptr;
  for (int x = tid; x < tpad + kBQ; x += kThreads) {
    const int dlt = min(max(x - (i0 + kBQ - 1), 1 - T), T - 1);
    bs[x] = bias_h ? bias_h[dlt + T - 1] : 0.f;
  }
  const float* mask_b = mask ? mask + (size_t)b * T : nullptr;
  for (int j = tid; j < tpad; j += kThreads)
    ms[j] = j < T ? (mask_b ? mask_b[j] : 0.f) : -INFINITY;
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane keeps the ring full
    if (tid == kConsumers) {
      tt::mbar_expect_tx(qbar, 2 * kTileBytes);
      tt::tma_load_3d(qs, &qkv_map, qbar, hc + q_off, i0, b);
      tt::tma_load_3d(qs + kTile, &qkv_map, qbar, hc + q_off, i0 + kBQ / 2, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages, n = t / kStages;
        if (n > 0) tt::mbar_wait(&empty[st], (n - 1) & 1);
        tt::mbar_expect_tx(&full[st], 2 * kTileBytes);
        tt::tma_load_3d(ks + st * kTile, &qkv_map, &full[st], hc + k_off,
                    t * kBK, b);
        tt::tma_load_3d(vs + st * kTile, &qkv_map, &full[st], hc + v_off,
                    t * kBK, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows i0 + 64 wg .. + 63; this thread holds
  // rows r0 and r0 + 8 of the accumulators (mma fragment layout)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = i0 + wg * 64 + warp * 16 + g;
  const int wg_last = i0 + wg * 64 + 63;  // last row of the warpgroup
  const uint64_t dq = sw128_desc(qs + wg * kTile);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  tt::mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages, j0 = t * kBK;
    tt::mbar_wait(&full[st], (t / kStages) & 1);
    if (!kCausal || j0 <= wg_last) {
      float s[32];
      const uint64_t dk = sw128_desc(ks + st * kTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // over the head width, 16 at a time
        wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        const int jr = (i >> 2) * 8 + tg * 2 + (i & 1);  // key in the tile
        const int row = r0 + half * 8;
        float v = (s[i] * scale + ms[j0 + jr] +
                   bs[j0 + jr - row + i0 + kBQ - 1]) * kLog2e;
        if (kCausal && j0 + jr > row) v = -INFINITY;
        s[i] = v;
        mx[half] = fmaxf(mx[half], v);
      }
      float mb[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        const float mn = fmaxf(m[half], mx[half]);
        mb[half] = mn == -INFINITY ? 0.f : mn;  // no valid key yet
        const float corr = ex2(m[half] - mb[half]);  // 0 while m is -inf
        l[half] *= corr;
        m[half] = mn;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == half) o[i] *= corr;
      }
      uint32_t pa[4][4];  // P as the A operand of the 4 key steps
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int half = (i >> 1) & 1;
        const float p0 = ex2(s[i] - mb[half]), p1 = ex2(s[i + 1] - mb[half]);
        l[half] += p0 + p1;
        // S chunk j = i / 4 covers keys 8j..8j+7: key step j / 2, register
        // (row half) + 2 * (second 8 keys of the step)
        pa[i >> 3][half + 2 * ((i >> 2) & 1)] = pack_bf16(p0, p1);
      }
      const uint64_t dv = sw128_desc(vs + st * kTile);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // over the tile's keys, 16 at a time
        wgmma_rs_tb(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) tt::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int i = r0 + half * 8;
    if (i < T) {
      const float inv = 1.f / fmaxf(l[half], 1e-30f);
      __nv_bfloat16* orow = out + ((size_t)b * T + i) * H * kD + h * kD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tg * 2) = pack_bf16(
            o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
}

size_t smem_bytes(int T) {
  const int tpad = (T + kBK - 1) / kBK * kBK;
  return 1024 + kOffF32 + sizeof(float) * (2 * tpad + kBQ);
}

template <bool kCausal>
int launch(const void* qkv, int B, int T, int H, int D, int q_off, int k_off,
           int v_off, int head_stride, const float* bias, const float* mask, float scale,
           void* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(T);
  if (D != kD || B < 1 || T < 1 || H < 1 || smem > 232448 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  tt::EncodeTiled encode = tt::encode_tiled();
  if (!encode) return (int)cudaErrorInvalidValue;
  const cuuint64_t c3 = 3ull * H * kD;
  const cuuint64_t dims[3] = {c3, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {c3 * 2, c3 * 2 * T};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {kD, kBK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attn_kernel<kCausal><<<grid, kThreads, smem, stream>>>(
      map, T, H, q_off, k_off, v_off, head_stride, bias, mask, scale,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B. qkv (B, T, 3*H*D) bf16 interleaved per head, 16-byte aligned;
// bias (H, 2T-1) f32 or null; mask (B, T) f32 additive or null; out
// (B, T, H*D) bf16. Channel offsets: q, k, v of head 0 at 0, D, 2D; head
// h adds h * 3D.
TT_EXPORT int tt_flash_packed(const void* qkv, int B, int T, int H, int D,
                              const float* bias, const float* mask,
                              float scale, void* out, cudaStream_t stream) {
  return launch<false>(qkv, B, T, H, D, 0, kD, 2 * kD, 3 * kD, bias, mask,
                       scale, out, stream);
}

// Kernel C. qkv (B, S, 3*H*D) bf16 part-major, 16-byte aligned; mask
// (B, S) f32 additive or null; out (B, S, H*D) bf16. Channel offsets: q,
// k, v of head 0 at 0, H*D, 2*H*D; head h adds h * D.
TT_EXPORT int tt_flash_causal_qkv(const void* qkv, int B, int S, int H, int D,
                                  const float* mask, float scale, void* out,
                                  cudaStream_t stream) {
  return launch<true>(qkv, B, S, H, D, 0, H * kD, 2 * H * kD, kD, nullptr,
                      mask, scale, out, stream);
}
