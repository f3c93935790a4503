// AR decode trunk for one token step (kernel A).
//
// Replaces tortoise_tpu/ops/pallas/decode_trunk.py::fused_decode_trunk
// (the Pallas kernel runs all layers as one sequential (L, B) grid that
// carries the activation in VMEM). Hopper blocks run unordered, so the
// step is split into launches that each finish a whole phase for all
// rows; tt_decode_trunk issues them for every layer from one host call:
//
//   1. LN1 + int8 qkv matvec          matvec_q8_kernel<LN_ONE>
//   2. cached attention + fresh column decode_attn_kernel
//   3. int8 proj matvec + residual     matvec_q8_kernel<LN_NONE>
//   4. LN2 + int8 fc matvec + GELU     matvec_q8_kernel<LN_ONE>
//   5. int8 fc_proj matvec + residual  matvec_q8_kernel<LN_NONE>
//
// then optionally the double-LN int8 lm head (tt_decode_head) and the
// sampler (tt_decode_sample, one block per row).
//
// What bounds it on the card: streaming the int8 weights (~12 MB a layer
// at d=1024) and the bf16 KV cache slice, once per step, for B <= 16 rows.
// Each matvec block owns 128 output columns and a slice of the rows, reads
// each weight byte once with 4-byte loads (one warp covers a 128-byte row
// segment) and applies it to all B rows, so the weight stream does not
// grow with B; the row split keeps a few blocks per SM in flight. The
// activations stay in f32; matvec operands are rounded to bf16 and the
// int8 weight is exact in bf16, so every product is exact in f32 and only
// the summation order differs from the Pallas kernel. Launch overhead
// (~5 launches a layer) is the next cost; a persistent kernel or a CUDA
// graph is later work.
#include "common.cuh"

namespace {

constexpr int kMaxB = 16;     // rows per step (FUSED_MAX_BATCH)
constexpr int kMvThreads = 256;
constexpr int kMvWarps = kMvThreads / 32;
constexpr int kMvCols = 128;  // 32 lanes x 4 columns
constexpr int kMaxLnD = 1024; // LN-fused matvec input width
constexpr int kAttnThreads = 512;
constexpr int kDh = 64;       // head width
constexpr int kMaxC = 4096;   // cache slots
constexpr int kSmpThreads = 256;
constexpr int kMaxVp = 10240; // padded vocab
constexpr int kMaxTopK = 128;
constexpr int kMaxSplit = 32; // row splits of one matvec
constexpr float kF32Lowest = -3.4028234663852886e38f;

enum { LN_NONE = 0, LN_ONE = 1, LN_HEAD = 2 };
enum { EPI_STORE = 0, EPI_GELU_BF16 = 1, EPI_RESID = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// LN of one length-n row `src` (two-pass mean/variance, like the JAX
// layer_norm) with affine (w, b); w == nullptr means no affine.
__device__ void ln_row(const float* src, int n, const float* w,
                       const float* b, float eps, float* dst, float* red) {
  float s = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) s += src[k];
  const float mean = tt::block_sum(s, red) / (float)n;
  float v = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float d = src[k] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(tt::block_sum(v, red) / (float)n + eps);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float y = (src[k] - mean) * inv;
    if (w) y = y * w[k] + b[k];
    dst[k] = y;
  }
  __syncthreads();
}

// out[b, n] = (sum_k bf16(y[b, k]) * wq[k, n]) * scale[n] + bias[n]
// y is LN(x) (LN_ONE), the head's double-LN chain (LN_HEAD), or a bf16
// input read from device memory (LN_NONE).
//
// Grid (N / 128 column tiles, KS row splits): block (tile, ky) sums rows
// [ky*kc, (ky+1)*kc) for its 128 columns and all B rows into
// partial[ky][b][n]; the last block of a tile to finish (an atomic count
// per tile, reset by that block) adds the KS partials in ky order and
// applies the epilogue, so the result is deterministic. The split puts
// enough blocks in flight to stream the weights at a useful fraction of
// the card's bandwidth even for the 1024-column matrices.
template <int kLn>
__global__ void __launch_bounds__(kMvThreads)
matvec_q8_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ xin,
                 const float* ln_w, const float* ln_b, const float* ln2_w,
                 const float* ln2_b, float eps,
                 const int8_t* __restrict__ wq, const float* __restrict__ scale,
                 const float* __restrict__ bias, int B, int K, int N, int kc,
                 int epi, float* out_f32, __nv_bfloat16* out_bf, float* resid,
                 float* partial, unsigned int* counters) {
  __shared__ __nv_bfloat16 ys[kLn != LN_NONE ? kMaxB * kMaxLnD : 1];
  __shared__ float tmp[kLn != LN_NONE ? 2 * kMaxLnD : 1];
  __shared__ float red[32];
  __shared__ float part[kMvWarps][kMvCols];
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (kLn != LN_NONE) {
    for (int b = 0; b < B; ++b) {
      const float* xr = x + (size_t)b * K;
      if (kLn == LN_ONE) {
        ln_row(xr, K, ln_w, ln_b, eps, tmp, red);
      } else {
        ln_row(xr, K, ln_w, ln_b, eps, tmp + kMaxLnD, red);
        ln_row(tmp + kMaxLnD, K, nullptr, nullptr, eps, tmp, red);
        for (int k = tid; k < K; k += blockDim.x)
          tmp[k] = tmp[k] * ln2_w[k] + ln2_b[k];
        __syncthreads();
      }
      for (int k = tid; k < K; k += blockDim.x)
        ys[b * K + k] = __float2bfloat16(tmp[k]);
      __syncthreads();
    }
  }

  const int n0 = blockIdx.x * kMvCols + lane * 4;
  const int kb0 = blockIdx.y * kc, kb1 = min(K, kb0 + kc);
  const int kchunk = (kb1 - kb0 + kMvWarps - 1) / kMvWarps;
  const int k0 = kb0 + warp * kchunk, k1 = min(kb1, k0 + kchunk);
  float acc[kMaxB][4];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;

  if (n0 < N) {
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const char4 w4 = *reinterpret_cast<const char4*>(wq + (size_t)k * N + n0);
      const float w0 = w4.x, w1 = w4.y, w2 = w4.z, w3 = w4.w;
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          const float yv = kLn != LN_NONE
                               ? __bfloat162float(ys[b * K + k])
                               : __bfloat162float(xin[(size_t)b * K + k]);
          acc[b][0] = fmaf(yv, w0, acc[b][0]);
          acc[b][1] = fmaf(yv, w1, acc[b][1]);
          acc[b][2] = fmaf(yv, w2, acc[b][2]);
          acc[b][3] = fmaf(yv, w3, acc[b][3]);
        }
      }
    }
  }

  const int n = blockIdx.x * kMvCols + tid;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    if (b < B) {
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 4; ++c) part[warp][lane * 4 + c] = acc[b][c];
      __syncthreads();
      if (tid < kMvCols && n < N) {
        float s = 0.f;
        for (int w = 0; w < kMvWarps; ++w) s += part[w][tid];
        partial[((size_t)blockIdx.y * B + b) * N + n] = s;
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < kMvCols && n < N) {
    for (int b = 0; b < B; ++b) {
      float s = 0.f;
      for (int ky = 0; ky < (int)gridDim.y; ++ky)
        s += __ldcg(partial + ((size_t)ky * B + b) * N + n);
      const float val = s * scale[n] + bias[n];
      const size_t o = (size_t)b * N + n;
      if (epi == EPI_STORE) out_f32[o] = val;
      else if (epi == EPI_GELU_BF16) out_bf[o] = __float2bfloat16(gelu_tanh(val));
      else resid[o] += val;
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0u;  // ready for the next launch
}

// Launch geometry of one matvec: KS row splits so that ~4 blocks per SM
// are in flight, with at least 128 rows (16 per warp) per block.
struct MvLaunch {
  dim3 grid;
  int kc;
};

MvLaunch mv_launch(int K, int N) {
  const int tiles = N / kMvCols;
  int ks = (4 * 132 + tiles - 1) / tiles;
  ks = max(1, min(ks, min(kMaxSplit, K / 128)));
  const int kc = (K + ks - 1) / ks;
  return {dim3(tiles, (K + kc - 1) / kc), kc};
}

// One block per (row b, head h): softmax(q.K / sqrt(Dh) + bias_row) over
// the cached keys with the fresh token's own key folded into the max and
// the denominator, then the context over the cached values plus the fresh
// value. Writes the merged context (bf16, the proj matvec's operand) and
// the fresh K/V rows in the cache dtype. Cache rows are read as 16-byte
// loads: 8 lanes cover one 64-wide head row, a warp four rows at a time.
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_kernel(const float* __restrict__ qkv, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc,
                   const float* __restrict__ bias_row, int C, int H, float scale,
                   __nv_bfloat16* merged, __nv_bfloat16* krow,
                   __nv_bfloat16* vrow) {
  constexpr int kGroups = kAttnThreads / 8;  // slot groups in the P@V phase
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HD = H * kDh;
  __shared__ float s[kMaxC];
  __shared__ float qs[kDh], qb[kDh], kn[kDh], vn[kDh];
  __shared__ float red[32];
  __shared__ float ctxp[kGroups][kDh];
  __shared__ float self_s;

  const float* row = qkv + (size_t)b * 3 * HD;
  if (tid < kDh) {
    const float q = row[h * kDh + tid] * scale;
    qs[tid] = q;
    qb[tid] = tt::bf16_round(q);
    const float k = row[HD + h * kDh + tid];
    const float v = row[2 * HD + h * kDh + tid];
    kn[tid] = k;
    vn[tid] = v;
    krow[(size_t)b * HD + h * kDh + tid] = __float2bfloat16(k);
    vrow[(size_t)b * HD + h * kDh + tid] = __float2bfloat16(v);
  }
  __syncthreads();
  if (warp == 0) {
    const float t = tt::warp_sum(qs[lane] * kn[lane] + qs[lane + 32] * kn[lane + 32]);
    if (lane == 0) self_s = t;
  }

  const __nv_bfloat16* kb = kc + (size_t)b * C * HD + h * kDh;
  const __nv_bfloat16* vb = vc + (size_t)b * C * HD + h * kDh;
  const float* br = bias_row + (size_t)b * C;
  const int sub = lane >> 3, part = lane & 7;  // slot within 4, 8-dim part
  float qr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qr[i] = qb[part * 8 + i];
  for (int c0 = warp * 4; c0 < C; c0 += (kAttnThreads / 32) * 4) {
    const int c = c0 + sub;
    float dot = 0.f;
    if (c < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kb + (size_t)c * HD + part * 8);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dot += qr[2 * i] * __low2float(k2[i]) + qr[2 * i + 1] * __high2float(k2[i]);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (part == 0 && c < C) s[c] = dot + br[c];
  }
  __syncthreads();

  float lmax = -INFINITY;
  for (int c = tid; c < C; c += kAttnThreads) lmax = fmaxf(lmax, s[c]);
  const float m = fmaxf(tt::block_max(lmax, red), self_s);
  float lsum = 0.f;
  for (int c = tid; c < C; c += kAttnThreads) {
    const float e = expf(s[c] - m);
    s[c] = e;
    lsum += e;
  }
  const float e_self = expf(self_s - m);
  const float denom = tt::block_sum(lsum, red) + e_self;  // syncs s[] too

  const int g = tid >> 3, dp = tid & 7;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int c = g; c < C; c += kGroups) {
    const float e = tt::bf16_round(s[c]);
    const uint4 raw = *reinterpret_cast<const uint4*>(vb + (size_t)c * HD + dp * 8);
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(e, __low2float(v2[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(e, __high2float(v2[i]), acc[2 * i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) ctxp[g][dp * 8 + i] = acc[i];
  __syncthreads();
  if (tid < kDh) {
    float ctx = 0.f;
    for (int i = 0; i < kGroups; ++i) ctx += ctxp[i][tid];
    ctx += e_self * vn[tid];
    merged[(size_t)b * HD + h * kDh + tid] = __float2bfloat16(ctx / denom);
  }
}

// Better of two (value, index) candidates: larger value, first index on
// ties (decode_trunk.py:97).
__device__ __forceinline__ void take_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// One block per row: repetition penalty on the previous token ->
// temperature -> iterative top-k (first index wins ties) -> suffix-sum
// nucleus drop (never the top candidate) -> inverse CDF against u.
__global__ void __launch_bounds__(kSmpThreads)
sample_kernel(const float* __restrict__ logits, const int* __restrict__ prev,
              const float* __restrict__ u, int Vp, float inv_temp, int top_k,
              float top_p_drop, float penalty, int* tok) {
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float x[kMaxVp];
  __shared__ float vals[kMaxTopK];
  __shared__ int ids[kMaxTopK];
  __shared__ float rv[kSmpThreads / 32];
  __shared__ int ri[kSmpThreads / 32];

  const int pv = prev[b];
  for (int i = tid; i < Vp; i += kSmpThreads) {
    float v = logits[(size_t)b * Vp + i];
    if (i == pv) v = v < 0.f ? v * penalty : v / penalty;
    x[i] = v * inv_temp;
  }
  __syncthreads();

  for (int it = 0; it < top_k; ++it) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < Vp; i += kSmpThreads) take_better(bv, bi, x[i], i);
    for (int o = 16; o > 0; o >>= 1)
      take_better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, o),
                  __shfl_xor_sync(0xffffffffu, bi, o));
    if (lane == 0) {
      rv[warp] = bv;
      ri[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float v = rv[0];
      int i = ri[0];
      for (int w = 1; w < kSmpThreads / 32; ++w) take_better(v, i, rv[w], ri[w]);
      vals[it] = v;
      ids[it] = i;
      x[i] = kF32Lowest;
    }
    __syncthreads();
  }

  if (tid == 0) {
    // vals is descending, so vals[0] is the max of the active lanes and,
    // since #0 is never dropped, of the kept ones too
    float p[kMaxTopK];
    float sum = 0.f;
    for (int c = 0; c < top_k; ++c) {
      p[c] = expf(vals[c] - vals[0]);
      sum += p[c];
    }
    float suffix = 0.f, sum2 = 0.f;
    for (int c = top_k - 1; c >= 0; --c) {
      suffix += p[c] / sum;
      const bool drop = c > 0 && suffix <= top_p_drop;
      if (drop) p[c] = 0.f;
      sum2 += p[c];
    }
    float cum = 0.f;
    int count = 0;
    for (int c = 0; c < top_k; ++c) {
      cum += p[c] / sum2;
      count += cum < u[b];
    }
    tok[b] = ids[min(count, top_k - 1)];
  }
}

}  // namespace

// Scratch the matvecs need: partial sums (floats) for up to kMaxSplit row
// splits of the widest matrix, and one counter per 128-column tile
// (zeroed once by the caller; every launch leaves them zero).
TT_EXPORT long long tt_decode_partial_floats(int B, int N) {
  return (long long)kMaxSplit * B * N;
}

namespace {

template <int kLn>
int matvec(const float* x, const __nv_bfloat16* xin, const float* w1,
           const float* b1, const float* w2, const float* b2, float eps,
           const int8_t* wq, const float* scale, const float* bias, int B,
           int K, int N, int epi, float* out_f32, __nv_bfloat16* out_bf,
           float* resid, float* partial, long long partial_cap,
           unsigned int* counters, cudaStream_t stream) {
  const MvLaunch g = mv_launch(K, N);
  if ((long long)g.grid.y * B * N > partial_cap)
    return (int)cudaErrorInvalidValue;
  matvec_q8_kernel<kLn><<<g.grid, kMvThreads, 0, stream>>>(
      x, xin, w1, b1, w2, b2, eps, wq, scale, bias, B, K, N, g.kc, epi,
      out_f32, out_bf, resid, partial, counters);
  return (int)cudaGetLastError();
}

}  // namespace

// The whole trunk for one decode step. x (B, D) f32 holds the embedded
// input and is updated in place into the final hidden state. Stacked
// per-layer weights: ln (L, D); int8 weights (L, in, out) with scales
// (L, 1, out) and biases (L, out). Cache K/V (L, B, C, D) bf16; the fresh
// rows go to k_rows/v_rows (L, B, D) bf16. Scratch: qkv_buf (B, 3D) f32,
// merged_buf (B, D) bf16, hdn_buf (B, F) bf16, partial (partial_cap
// floats) and counters (>= max(3D, F) / 128 zeroed uints).
TT_EXPORT int tt_decode_trunk(
    int L, int B, int C, int D, int H, int F, float eps, float* x,
    const float* bias_row, const float* ln1_w, const float* ln1_b,
    const int8_t* attn_w, const float* attn_s, const float* attn_b,
    const int8_t* proj_w, const float* proj_s, const float* proj_b,
    const float* ln2_w, const float* ln2_b, const int8_t* fc_w,
    const float* fc_s, const float* fc_b, const int8_t* fp_w,
    const float* fp_s, const float* fp_b, const void* cache_k,
    const void* cache_v, void* k_rows, void* v_rows, float* qkv_buf,
    void* merged_buf, void* hdn_buf, float* partial, long long partial_cap,
    unsigned int* counters, cudaStream_t stream) {
  if (B < 1 || B > kMaxB || D > kMaxLnD || D != H * kDh || C < 1 || C > kMaxC ||
      D % kMvCols || F % kMvCols)
    return (int)cudaErrorInvalidValue;
  const auto* ck = static_cast<const __nv_bfloat16*>(cache_k);
  const auto* cv = static_cast<const __nv_bfloat16*>(cache_v);
  auto* kr = static_cast<__nv_bfloat16*>(k_rows);
  auto* vr = static_cast<__nv_bfloat16*>(v_rows);
  auto* merged = static_cast<__nv_bfloat16*>(merged_buf);
  auto* hdn = static_cast<__nv_bfloat16*>(hdn_buf);
  const float scale = 1.f / sqrtf((float)kDh);
  const int D3 = 3 * D;
  int err = 0;
  for (int l = 0; l < L && !err; ++l) {
    err = matvec<LN_ONE>(
        x, nullptr, ln1_w + (size_t)l * D, ln1_b + (size_t)l * D, nullptr,
        nullptr, eps, attn_w + (size_t)l * D * D3, attn_s + (size_t)l * D3,
        attn_b + (size_t)l * D3, B, D, D3, EPI_STORE, qkv_buf, nullptr,
        nullptr, partial, partial_cap, counters, stream);
    if (err) break;
    decode_attn_kernel<<<B * H, kAttnThreads, 0, stream>>>(
        qkv_buf, ck + (size_t)l * B * C * D, cv + (size_t)l * B * C * D,
        bias_row, C, H, scale, merged, kr + (size_t)l * B * D,
        vr + (size_t)l * B * D);
    err = (int)cudaGetLastError();
    if (err) break;
    err = matvec<LN_NONE>(
        nullptr, merged, nullptr, nullptr, nullptr, nullptr, eps,
        proj_w + (size_t)l * D * D, proj_s + (size_t)l * D,
        proj_b + (size_t)l * D, B, D, D, EPI_RESID, nullptr, nullptr, x,
        partial, partial_cap, counters, stream);
    if (err) break;
    err = matvec<LN_ONE>(
        x, nullptr, ln2_w + (size_t)l * D, ln2_b + (size_t)l * D, nullptr,
        nullptr, eps, fc_w + (size_t)l * D * F, fc_s + (size_t)l * F,
        fc_b + (size_t)l * F, B, D, F, EPI_GELU_BF16, nullptr, hdn, nullptr,
        partial, partial_cap, counters, stream);
    if (err) break;
    err = matvec<LN_NONE>(
        nullptr, hdn, nullptr, nullptr, nullptr, nullptr, eps,
        fp_w + (size_t)l * F * D, fp_s + (size_t)l * D, fp_b + (size_t)l * D,
        B, F, D, EPI_RESID, nullptr, nullptr, x, partial, partial_cap,
        counters, stream);
  }
  return err;
}

// lm head: LN(ln_f) -> bare LN -> lm_ln affine -> int8 (D, Vp) matvec
// with per-column scale and the -1e30-padded bias. logits (B, Vp) f32.
TT_EXPORT int tt_decode_head(int B, int D, int Vp, float eps, const float* x,
                             const float* lnf_w, const float* lnf_b,
                             const float* lmln_w, const float* lmln_b,
                             const int8_t* lm_wq, const float* lm_sc,
                             const float* lm_b, float* logits, float* partial,
                             long long partial_cap, unsigned int* counters,
                             cudaStream_t stream) {
  if (B < 1 || B > kMaxB || D > kMaxLnD || Vp % kMvCols)
    return (int)cudaErrorInvalidValue;
  return matvec<LN_HEAD>(x, nullptr, lnf_w, lnf_b, lmln_w, lmln_b, eps,
                         lm_wq, lm_sc, lm_b, B, D, Vp, EPI_STORE, logits,
                         nullptr, nullptr, partial, partial_cap, counters,
                         stream);
}

// Sampler over (B, Vp) logits: prev (B,) int32, u (B,) f32 -> tok (B,).
TT_EXPORT int tt_decode_sample(int B, int Vp, const float* logits,
                               const int* prev, const float* u, float inv_temp,
                               int top_k, float top_p_drop, float penalty,
                               int* tok, cudaStream_t stream) {
  if (B < 1 || Vp > kMaxVp || top_k < 1 || top_k > kMaxTopK || top_k > Vp)
    return (int)cudaErrorInvalidValue;
  sample_kernel<<<B, kSmpThreads, 0, stream>>>(logits, prev, u, Vp, inv_temp,
                                               top_k, top_p_drop, penalty, tok);
  return (int)cudaGetLastError();
}
