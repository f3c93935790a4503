// Exact-softmax attention straight off a fused qkv tensor (kernels B, C).
//
// Replaces tortoise_tpu/ops/pallas/flash_attention.py:
//   B  flash_attention_packed      — non-causal, per-head-interleaved qkv
//      (c = h*3D + part*D + d), T5 rel-pos bias, additive key mask;
//   C  flash_attention_causal_qkv  — causal, part-major qkv
//      (c = part*H*D + h*D + d), additive key mask.
//
// What bounds it on the card: ~4*T*T*D multiply-adds per (batch, head)
// (QK^T and PV) against a qkv read of only T*3*D bf16, so it is bound by
// the matrix units. Both products run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 sums). One block of 4 warps owns 64
// query rows of one (batch, head); each warp keeps its 16 rows' Q
// fragments, scores, softmax state and f32 output in registers and walks
// the keys in 64-key K/V tiles staged through shared memory, with an
// online softmax, so no (T, T) score block ever reaches device memory.
// The score fragments become the PV product's A operand in registers
// (the flash-attention-2 layout identity); V's B fragments come from
// shared memory through ldmatrix.trans. Rows are padded to 72 bf16 so
// the fragment reads hit 32 distinct banks. wgmma, TMA and a
// double-buffered K/V ring are later work.
//
// Numerics follow the Pallas kernels: bf16 q/k/v, f32 scores, the
// softmax weights rounded to bf16 before the PV product, f32 normaliser
// summed from the unrounded weights, output rounded to bf16. The score
// scale 1/sqrt(64) is a power of two, so scaling the f32 score equals
// scaling q. The bias arrives as a per-head Toeplitz vector
// bias[h, (j - i) + T - 1] (the bucket ids depend only on j - i); the
// mask as an additive 0 / -1e30 row per batch row.
#include "common.cuh"

namespace {

constexpr int kD = 64;            // head width the kernels are built for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block (16 per warp)
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kLd = kD + 8;       // padded smem row (bf16 elements)

using tt::ldmatrix_x2_trans;
using tt::mma_bf16;
using tt::pack_bf16;

template <bool kInterleaved, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const __nv_bfloat16* __restrict__ qkv, int T, int H,
            const float* __restrict__ bias, const float* __restrict__ mask,
            float scale, __nv_bfloat16* __restrict__ out) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row / column pair
  const size_t rs = (size_t)3 * H * kD;    // qkv row stride
  const int q_off = kInterleaved ? h * 3 * kD : h * kD;
  const int k_off = kInterleaved ? h * 3 * kD + kD : H * kD + h * kD;
  const int v_off = kInterleaved ? h * 3 * kD + 2 * kD : 2 * H * kD + h * kD;
  const __nv_bfloat16* base = qkv + (size_t)b * T * rs;
  const int i0 = qt * kBQ;            // first query row of the block
  const int wr = i0 + warp * 16 + g;  // this thread's rows: wr and wr + 8

  __shared__ __align__(16) __nv_bfloat16 ks[kBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][kLd];
  __shared__ float bs[kBQ + kBK - 1];  // bias of j - i in this tile pair
  __shared__ float ms[kBK];            // additive key mask (-inf past T)

  // Q as the A operand of the 4 k-steps over the head width
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = wr + (x & 1) * 8, col = kk * 16 + tg * 2 + (x >> 1) * 8;
      qf[kk][x] = row < T ? *reinterpret_cast<const uint32_t*>(
                                base + (size_t)row * rs + q_off + col)
                          : 0u;
    }
  }

  float o[8][4];  // 16 rows x 64 dims: 8 fragments of 8 dims
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* bias_h = bias ? bias + (size_t)h * (2 * T - 1) + (T - 1) : nullptr;
  const float* mask_b = mask ? mask + (size_t)b * T : nullptr;
  const int kend = kCausal ? min(T, i0 + kBQ) : T;

  for (int j0 = 0; j0 < kend; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * kD / 8; e += kThreads) {
      const int r = e >> 3, c = (e & 7) * 8, j = j0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < T) {
        kv = *reinterpret_cast<const uint4*>(base + (size_t)j * rs + k_off + c);
        vv = *reinterpret_cast<const uint4*>(base + (size_t)j * rs + v_off + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    if (bias_h) {
      for (int x = tid; x < kBQ + kBK - 1; x += kThreads) {
        const int dlt = min(max(j0 - i0 - (kBQ - 1) + x, 1 - T), T - 1);
        bs[x] = bias_h[dlt];
      }
    }
    for (int r = tid; r < kBK; r += kThreads) {
      const int j = j0 + r;
      ms[r] = j < T ? (mask_b ? mask_b[j] : 0.f) : -INFINITY;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys as 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + tg * 2];
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int half = c >> 1, jr = nt * 8 + tg * 2 + (c & 1);
        const int i = wr + half * 8;
        float v = s[nt][c] * scale + ms[jr];
        if (bias_h) v += bs[jr - (i - i0) + kBQ - 1];
        if (kCausal && j0 + jr > i) v = -INFINITY;
        s[nt][c] = v;
        mx[half] = fmaxf(mx[half], v);
      }
    }
    float mb[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float mn = fmaxf(m[half], mx[half]);
      mb[half] = mn == -INFINITY ? 0.f : mn;  // no valid key yet
      const float corr = expf(m[half] - mb[half]);  // 0 while m is -inf
      l[half] *= corr;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][2 * half] *= corr;
        o[dt][2 * half + 1] *= corr;
      }
      m[half] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[nt][c] - mb[c >> 1]);
        l[c >> 1] += p;
        s[nt][c] = p;
      }
    }

    // o += P V: the score fragments of keys 16kk..16kk+15 are the A
    // operand of k-step kk; V (key-major in smem) is read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[kk * 16 + (lane & 15)][dt * 8]);
        mma_bf16(o[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int i = wr + half * 8;
    if (i < T) {
      const float inv = 1.f / fmaxf(l[half], 1e-30f);
      __nv_bfloat16* orow = out + ((size_t)b * T + i) * H * kD + h * kD;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + tg * 2) = pack_bf16(
            o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
    }
  }
}

template <bool kInterleaved, bool kCausal>
int launch(const void* qkv, int B, int T, int H, int D, const float* bias,
           const float* mask, float scale, void* out, cudaStream_t stream) {
  if (D != kD || B < 1 || T < 1 || H < 1 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  attn_kernel<kInterleaved, kCausal><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), T, H, bias, mask, scale,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B. qkv (B, T, 3*H*D) bf16 interleaved per head, 16-byte aligned;
// bias (H, 2T-1) f32 or null; mask (B, T) f32 additive or null; out
// (B, T, H*D) bf16.
TT_EXPORT int tt_flash_packed(const void* qkv, int B, int T, int H, int D,
                              const float* bias, const float* mask,
                              float scale, void* out, cudaStream_t stream) {
  return launch<true, false>(qkv, B, T, H, D, bias, mask, scale, out, stream);
}

// Kernel C. qkv (B, S, 3*H*D) bf16 part-major, 16-byte aligned; mask
// (B, S) f32 additive or null; out (B, S, H*D) bf16.
TT_EXPORT int tt_flash_causal_qkv(const void* qkv, int B, int S, int H, int D,
                                  const float* mask, float scale, void* out,
                                  cudaStream_t stream) {
  return launch<false, true>(qkv, B, S, H, D, nullptr, mask, scale, out,
                             stream);
}
