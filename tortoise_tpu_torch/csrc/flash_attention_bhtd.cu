// Exact-softmax attention over strided (B, H, T, D) views (kernels D1, D2).
//
// Replaces tortoise_tpu/ops/pallas/flash_attention.py::flash_attention,
// both of its bodies. D1's bf16 work at head widths 32, 64 and 128 runs
// on the wgmma + TMA body of flash_attention.cu; what stays here is D2's
// generic modes (causal on the (B, H, T, D) API, a materialized bias, f32
// output), every f32 input (the FMA body), and head width 16 (the tiny
// configs) on the mma.sync body:
//   D1 _grouped_flash / _attn_kernel_rowblock — non-causal, square, T5
//      band + far-field bias (the diffusion fallback when the packed
//      kernel cannot take the head layout); output in q's dtype;
//   D2 _attn_kernel — the generic online-softmax body: no bias, a
//      materialized (H, Tq, Tkv) bias, or the Toeplitz bucket bias; an
//      optional causal flag; output f32.
// Both are one function here: the band + far-field bias and the bucket
// tiles are a per-head Toeplitz vector bias[h, (j - i) + Tq - 1] (bucket
// ids depend only on j - i), and the key mask is an additive 0 / -1e30
// row per batch row. The TPU kernels' layout work (T padded to 128, the
// (B, T, H, 3, D) -> (B, H, T, D) transposes, log2(e) folded into q) is
// not needed: q, k, v and the output are read and written through
// element strides for (b, h, t) with d contiguous, so a caller passes
// views of a fused qkv tensor and the output lands in (B, T, H*D).
//
// What bounds it on the card: ~4*Tq*Tkv*D multiply-adds per (batch,
// head) against a q/k/v read of (Tq + 2*Tkv)*D elements, so it is bound
// by the matrix units. bf16 inputs run the design of kernel B
// (flash_attention.cu), templated on the head width D in {16, 32, 64,
// 128}: one block of 4 warps owns 64 query rows of one (batch, head);
// each warp keeps its 16 rows' Q fragments, scores, softmax state and
// f32 output in registers; K/V stream through shared memory in 64-key
// tiles; QK^T and PV run as mma.sync.m16n8k16 (bf16 in, f32 sums), with
// the softmax weights rounded to bf16 before PV as in the Pallas kernel.
// f32 inputs (the parity plane) run a plain-FMA body: one warp per query
// row, one key per lane for the scores, one head dim per lane for PV.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per mma block (16 per warp)
constexpr int kBK = 64;           // keys per shared-memory tile

using tt::ldmatrix_x2_trans;
using tt::mma_bf16;
using tt::pack_bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, t)
  int H, Tq, Tkv;
  const float* bias_vec;   // (H, Tq + Tkv - 1) or null
  const float* bias_full;  // (H, Tq, Tkv) or null
  const float* mask;       // (B, Tkv) additive or null
  float scale;
  int causal;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// kGeneral compiles in the causal flag and the materialized bias (D2's
// modes off the main paths); without it the score loop tests neither.
template <int D, typename OutT, bool kGeneral>
__global__ void __launch_bounds__(kThreads) attn_mma(const Args a) {
  constexpr int kLd = D + 8;  // padded smem row: fragment reads hit 32 banks
  constexpr int kKS = D / 16;  // k-steps of the QK^T product
  constexpr int kDT = D / 8;   // 8-wide output fragments
  constexpr int kChunks = D / 8;  // 16-byte chunks per K/V row
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row / column pair
  const int Tq = a.Tq, Tkv = a.Tkv;
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + h * a.vs[1];
  const int i0 = qt * kBQ;            // first query row of the block
  const int wr = i0 + warp * 16 + g;  // this thread's rows: wr and wr + 8

  __shared__ __align__(16) __nv_bfloat16 ks[kBK][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][kLd];
  __shared__ float bs[kBQ + kBK - 1];  // Toeplitz bias of this tile pair
  __shared__ float ms[kBK];            // additive key mask (-inf past Tkv)

  uint32_t qf[kKS][4];  // Q as the A operand of the k-steps
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = wr + (x & 1) * 8, col = kk * 16 + tg * 2 + (x >> 1) * 8;
      qf[kk][x] = row < Tq ? *reinterpret_cast<const uint32_t*>(
                                 qb + row * a.qs[2] + col)
                           : 0u;
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* bias_h =
      a.bias_vec ? a.bias_vec + (size_t)h * (Tq + Tkv - 1) + (Tq - 1) : nullptr;
  const float* full_h = a.bias_full ? a.bias_full + (size_t)h * Tq * Tkv : nullptr;
  const float* mask_b = a.mask ? a.mask + (size_t)b * Tkv : nullptr;
  const int kend = kGeneral && a.causal ? min(Tkv, i0 + kBQ) : Tkv;

  for (int j0 = 0; j0 < kend; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8, j = j0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < Tkv) {
        kv = *reinterpret_cast<const uint4*>(kb + j * a.ks[2] + c);
        vv = *reinterpret_cast<const uint4*>(vb + j * a.vs[2] + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    if (bias_h) {
      for (int x = tid; x < kBQ + kBK - 1; x += kThreads) {
        const int dlt = min(max(j0 - i0 - (kBQ - 1) + x, 1 - Tq), Tkv - 1);
        bs[x] = bias_h[dlt];
      }
    }
    for (int r = tid; r < kBK; r += kThreads) {
      const int j = j0 + r;
      ms[r] = j < Tkv ? (mask_b ? mask_b[j] : 0.f) : -INFINITY;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys as 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
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
        const int i = wr + half * 8, j = j0 + jr;
        float v = s[nt][c] * a.scale + ms[jr];
        if (bias_h) v += bs[jr - (i - i0) + kBQ - 1];
        if (kGeneral && full_h && i < Tq && j < Tkv)
          v += full_h[(size_t)i * Tkv + j];
        if (kGeneral && a.causal && j > i) v = -INFINITY;
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
      for (int dt = 0; dt < kDT; ++dt) {
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
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[kk * 16 + (lane & 15)][dt * 8]);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }

  OutT* ob = static_cast<OutT*>(a.out) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int i = wr + half * 8;
    if (i < Tq) {
      const float inv = 1.f / fmaxf(l[half], 1e-30f);
      OutT* orow = ob + i * a.os[2];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        store_pair(orow + dt * 8 + tg * 2, o[dt][2 * half] * inv,
                   o[dt][2 * half + 1] * inv);
    }
  }
}

// f32 inputs: one warp per query row. Scores one key per lane (q in
// shared memory, the key row read by its lane), the online-softmax
// update across the warp, then PV with the lane's head dims.
template <int D>
__global__ void __launch_bounds__(kThreads) attn_f32(const Args a) {
  constexpr int kDPL = (D + 31) / 32;  // head dims per lane
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;  // this warp's query row
  const int Tq = a.Tq, Tkv = a.Tkv;
  __shared__ float qsm[kWarps][D];
  if (i >= Tq) return;  // whole warps leave; nothing below syncs the block
  const float* qrow = static_cast<const float*>(a.q) + b * a.qs[0] +
                      h * a.qs[1] + i * a.qs[2];
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  for (int d = lane; d < D; d += 32) qsm[warp][d] = qrow[d];
  __syncwarp();
  const float* bias_h =
      a.bias_vec ? a.bias_vec + (size_t)h * (Tq + Tkv - 1) + (Tq - 1) : nullptr;
  const float* full_row =
      a.bias_full ? a.bias_full + ((size_t)h * Tq + i) * Tkv : nullptr;
  const float* mask_b = a.mask ? a.mask + (size_t)b * Tkv : nullptr;
  const int kend = a.causal ? min(Tkv, i + 1) : Tkv;

  float o[kDPL], m = -INFINITY, l = 0.f;
#pragma unroll
  for (int u = 0; u < kDPL; ++u) o[u] = 0.f;
  for (int j0 = 0; j0 < kend; j0 += 32) {
    const int j = j0 + lane;
    float s = -INFINITY;
    if (j < kend) {
      const float* kr = kb + j * a.ks[2];
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qsm[warp][d], kr[d], acc);
      s = acc * a.scale;
      if (mask_b) s += mask_b[j];
      if (bias_h) s += bias_h[j - i];
      if (full_row) s += full_row[j];
    }
    const float mn = fmaxf(m, tt::warp_max(s));
    const float mb = mn == -INFINITY ? 0.f : mn;  // no valid key yet
    const float corr = expf(m - mb);
    const float p = expf(s - mb);
    l = l * corr + tt::warp_sum(p);
    m = mn;
#pragma unroll
    for (int u = 0; u < kDPL; ++u) o[u] *= corr;
    const int n = min(32, kend - j0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = vb + (j0 + jj) * a.vs[2];
#pragma unroll
      for (int u = 0; u < kDPL; ++u) {
        const int d = lane + 32 * u;
        if (d < D) o[u] = fmaf(pj, vr[d], o[u]);
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* orow = static_cast<float*>(a.out) + b * a.os[0] + h * a.os[1] +
                i * a.os[2];
#pragma unroll
  for (int u = 0; u < kDPL; ++u) {
    const int d = lane + 32 * u;
    if (d < D) orow[d] = o[u] * inv;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int D>
int launch(const Args& a, int B, int in_bf16, int out_bf16,
           cudaStream_t stream) {
  if (in_bf16) {
    // 16-byte K/V chunks, 4-byte Q pairs and output pairs
    for (int x = 0; x < 3; ++x)
      if (a.qs[x] % 8 || a.ks[x] % 8 || a.vs[x] % 8 || a.os[x] % 2)
        return (int)cudaErrorInvalidValue;
    if (!aligned(a.q, 16) || !aligned(a.k, 16) || !aligned(a.v, 16) ||
        !aligned(a.out, 8))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
    const bool general = a.causal || a.bias_full;
    if (out_bf16) {
      // bf16 output at head width 16 only: B and D1 there (a Toeplitz
      // bias) and C (causal); at widths 32-128 flash_attention.cu's
      // generic body takes them
      if constexpr (D == 16) {
        if (general)
          attn_mma<D, __nv_bfloat16, true><<<grid, kThreads, 0, stream>>>(a);
        else
          attn_mma<D, __nv_bfloat16, false><<<grid, kThreads, 0, stream>>>(a);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    } else if (general)
      attn_mma<D, float, true><<<grid, kThreads, 0, stream>>>(a);
    else
      attn_mma<D, float, false><<<grid, kThreads, 0, stream>>>(a);
  } else {
    if (out_bf16) return (int)cudaErrorInvalidValue;  // f32 in, f32 out
    const dim3 grid((a.Tq + kWarps - 1) / kWarps, a.H, B);
    attn_f32<D><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels D1/D2. q (B, H, Tq, D), k and v (B, H, Tkv, D) as strided views
// (d contiguous), all bf16 or all f32; strides[12] = element strides of
// (b, h, t) for q, k, v, out; out (B, H, Tq, D) in bf16 (out_bf16: bf16
// inputs at head width 16) or f32. bias_vec (H, Tq + Tkv - 1), bias_full
// (H, Tq, Tkv) and mask (B, Tkv) are f32 or null.
TT_EXPORT int tt_flash_bhtd(const void* q, const void* k, const void* v,
                            void* out, const long long* strides, int B, int H,
                            int Tq, int Tkv, int D, int in_bf16, int out_bf16,
                            const float* bias_vec, const float* bias_full,
                            const float* mask, float scale, int causal,
                            cudaStream_t stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  for (int x = 0; x < 3; ++x) {
    a.qs[x] = strides[x];
    a.ks[x] = strides[3 + x];
    a.vs[x] = strides[6 + x];
    a.os[x] = strides[9 + x];
  }
  a.H = H;
  a.Tq = Tq;
  a.Tkv = Tkv;
  a.bias_vec = bias_vec;
  a.bias_full = bias_full;
  a.mask = mask;
  a.scale = scale;
  a.causal = causal;
  switch (D) {
    case 16: return launch<16>(a, B, in_bf16, out_bf16, stream);
    case 32: return launch<32>(a, B, in_bf16, out_bf16, stream);
    case 64: return launch<64>(a, B, in_bf16, out_bf16, stream);
    case 128: return launch<128>(a, B, in_bf16, out_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
