// Exact-softmax attention on f32 inputs over strided (B, H, T, D) views
// (every attention kernel on the f32 parity plane).
//
// Replaces, where q, k and v are f32 (bf16 inputs run the wgmma + TMA
// body of flash_attention.cu), in tortoise_tpu/ops/pallas/flash_attention.py:
//   B flash_attention_packed — non-causal, T5 bias, key mask, on views
//      of the per-head-interleaved qkv;
//   C flash_attention_causal_qkv — causal, key mask, on views of the
//      part-major qkv;
//   D1 flash_attention's _grouped_flash / _attn_kernel_rowblock —
//      non-causal, square, T5 band + far-field bias;
//   D2 flash_attention's _attn_kernel — the generic online-softmax body:
//      no bias, a materialized (H, Tq, Tkv) bias, or the Toeplitz bucket
//      bias; an optional causal flag.
// All are one function here, with an f32 output: the band + far-field
// bias and the bucket tiles are a per-head Toeplitz vector
// bias[h, (j - i) + Tq - 1] (bucket ids depend only on j - i), and the key
// mask is an additive 0 / -1e30 row per batch row. q, k, v and the output
// are read and written through element strides for (b, h, t) with d
// contiguous, so a caller passes views of a fused qkv tensor.
//
// What bounds it on the card: ~4*Tq*Tkv*D f32 FLOPs per (batch, head)
// outside the tensor cores (67 TFLOP/s on an H100). The body is plain:
// one warp per query row, one key per lane for the scores (q in shared
// memory, the key row read by its lane), the online-softmax update across
// the warp, then PV with one head dim per lane.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

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

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.Tq + kWarps - 1) / kWarps, a.H, B);
  attn_f32<D><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels B, C, D1 and D2 on f32 inputs. q (B, H, Tq, D), k and v
// (B, H, Tkv, D) as strided f32 views (d contiguous); strides[12] =
// element strides of (b, h, t) for q, k, v, out; out (B, H, Tq, D) f32.
// bias_vec (H, Tq + Tkv - 1), bias_full (H, Tq, Tkv) and mask (B, Tkv)
// are f32 or null.
TT_EXPORT int tt_flash_bhtd(const void* q, const void* k, const void* v,
                            void* out, const long long* strides, int B, int H,
                            int Tq, int Tkv, int D, const float* bias_vec,
                            const float* bias_full, const float* mask,
                            float scale, int causal, cudaStream_t stream) {
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
    case 16: return launch<16>(a, B, stream);
    case 32: return launch<32>(a, B, stream);
    case 64: return launch<64>(a, B, stream);
    case 128: return launch<128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
