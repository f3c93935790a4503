// Location-variable convolution + gate + residual (kernel E).
//
// Replaces tortoise_tpu/ops/pallas/lvc.py::lvc_gated_residual: for hop
// chunk l of batch row b,
//   y[o, l*hop + s] = bias[o, l] + sum_{i,k} x[i, l*hop + s + k - pad] * K[i, o, k, l]
//   out[c, t] = residual[c, t] + sigmoid(y[c, t]) * tanh(y[c + C, t])
// with x zero outside [0, T), all in f32.
//
// What bounds it on the card: the predicted kernel. It is
// C_in*2C*K*L f32 per batch row and conv block (54 MB at the vocoder's
// widths for 500 latents), read once, whatever the hop; at hop 256 x,
// the residual and the output add 72 MB each, and the products (2C*C_in*K
// = 6144 multiply-adds per sample, 3.5 G there) take the f32 FMA units
// about as long as those bytes take the memory. The design reads each
// byte once and keeps the FMA units fed:
// - one block owns one batch row and kNL = 4 consecutive chunks. The
//   kernel arrives in its native (B, C_in, 2C, K, L) layout, where L is
//   the contiguous axis, so one 16-byte load brings a row's 4 chunks;
//   each thread keeps 8 such loads in flight. The slices are stored
//   transposed in shared memory, [(i*K + k)*2C + o];
// - one thread owns one sample and all 2C outputs (registers): each x
//   value feeds 2C FMAs, whose weights arrive as 16-byte shared loads that
//   the warp's lanes share. Consecutive threads own consecutive samples,
//   so the x and residual reads and the output write are coalesced;
// - x is read straight from device memory with its one-sample halo (L1
//   serves the K overlapping reads): the TPU kernel's K pre-shifted copies
//   of x and its chunk-major transposes are not needed.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNL = 4;      // chunks staged per block (one 16-byte load a row)
constexpr int kBatch = 8;   // staging loads in flight per thread

// K taps and C2 = 2C outputs are compile-time (the accumulators live in
// registers); C_in, L and hop are not.
template <int K, int C2>
__global__ void __launch_bounds__(kThreads)
lvc_kernel(const float* __restrict__ x, const float* __restrict__ kern,
           const float* __restrict__ bias, const float* __restrict__ res,
           float* __restrict__ out, int c_in, int L, int hop,
           long long kern_sb, long long bias_sb, int slice) {
  constexpr int CR = C2 / 2, pad = (K - 1) / 2;
  extern __shared__ float4 sm4[];
  float* ks = reinterpret_cast<float*>(sm4);  // [kNL][slice]: [(i*K + k)*C2 + o]
  float* bs = ks + kNL * slice;               // [kNL][C2]
  const int b = blockIdx.y, l0 = blockIdx.x * kNL, tid = threadIdx.x;
  const long long T = (long long)L * hop;
  const float* kb = kern + b * kern_sb;
  const float* bb = bias + b * bias_sb;

  // stage: row (i, o, k) holds chunk l at ((i*C2 + o)*K + k)*L + l, so a
  // row's kNL chunks are consecutive floats: one 16-byte load when
  // aligned and in range, kBatch rows in flight per thread
  const int rows = c_in * C2 * K;
  const bool vec = L % kNL == 0 && l0 + kNL <= L &&
                   reinterpret_cast<uintptr_t>(kb) % 16 == 0;
  for (int r0 = tid; r0 < rows; r0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = r0 + u * kThreads;
      const float* src = kb + (size_t)row * L + l0;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows) {
        if (vec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v[u].x = __ldg(src);
          if (l0 + 1 < L) v[u].y = __ldg(src + 1);
          if (l0 + 2 < L) v[u].z = __ldg(src + 2);
          if (l0 + 3 < L) v[u].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int row = r0 + u * kThreads;
      if (row >= rows) break;
      const int k = row % K, o = (row / K) % C2, i = row / (K * C2);
      float* dst = ks + (i * K + k) * C2 + o;
      dst[0] = v[u].x;
      dst[slice] = v[u].y;
      dst[2 * slice] = v[u].z;
      dst[3 * slice] = v[u].w;
    }
  }
  for (int e = tid; e < kNL * C2; e += kThreads) {
    const int q = e % kNL, o = e / kNL, l = l0 + q;
    bs[q * C2 + o] = l < L ? bb[(size_t)o * L + l] : 0.f;
  }
  __syncthreads();

  // one sample per thread, all C2 outputs: every x value feeds C2 FMAs
  // with weights that the warp's lanes share (one chunk, or a few at
  // small hops, per warp)
  const float* xb = x + (size_t)b * c_in * T;
  const size_t rb = (size_t)b * CR * T;
  const int span = min(kNL, L - l0) * hop;
  for (int p = tid; p < span; p += kThreads) {
    const int q = p / hop;
    const long long t = (long long)l0 * hop + p;
    const float* kq = ks + q * slice;
    float acc[C2];
#pragma unroll
    for (int o = 0; o < C2; ++o) acc[o] = 0.f;
    // unrolled so the x loads of several channels are in flight at once
#pragma unroll 4
    for (int i = 0; i < c_in; ++i) {
      const float* xr = xb + (size_t)i * T;
      float xv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long tt = t + k - pad;
        xv[k] = (tt >= 0 && tt < T) ? __ldg(xr + tt) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4* w = reinterpret_cast<const float4*>(kq + (i * K + k) * C2);
#pragma unroll
        for (int c4 = 0; c4 < C2 / 4; ++c4) {
          const float4 ww = w[c4];
          acc[4 * c4] = fmaf(xv[k], ww.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(xv[k], ww.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(xv[k], ww.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(xv[k], ww.w, acc[4 * c4 + 3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CR; ++c) {
      const float gate = acc[c] + bs[q * C2 + c];
      const float filt = acc[CR + c] + bs[q * C2 + CR + c];
      const size_t idx = rb + (size_t)c * T + t;
      out[idx] = res[idx] + tanhf(filt) / (1.f + expf(-gate));
    }
  }
}

template <int K, int C2>
int launch(const float* x, const float* kern, const float* bias,
           const float* res, float* out, int B, int c_in, int L, int hop,
           long long kern_sb, long long bias_sb, cudaStream_t stream) {
  // padded slice: a multiple of 4 floats (16-byte loads) and 4 banks off
  // a multiple of 32, so the up-to-4 chunks of one warp hit distinct banks
  const int slice = (c_in * K * C2 + 3) / 4 * 4 + 4;
  const size_t smem = (size_t)kNL * (slice + C2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lvc_kernel<K, C2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((L + kNL - 1) / kNL, B);
  lvc_kernel<K, C2><<<grid, kThreads, smem, stream>>>(
      x, kern, bias, res, out, c_in, L, hop, kern_sb, bias_sb, slice);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel E. x (B, C_in, T) and residual/out (B, C, T) contiguous f32;
// kernel (B, C_in, 2C, K, L) and bias (B, 2C, L) f32, contiguous within
// a batch row, with batch strides kern_sb / bias_sb (elements); T = L*hop.
// K = 3 and C in {4, 8, 16, 32}. Shared memory: 4 chunk slices of the
// kernel (98 KB at the vocoder's widths).
TT_EXPORT int tt_lvc_gated_residual(const float* x, const float* kern,
                                    const float* bias, const float* res,
                                    float* out, int B, int c_in, int c_res,
                                    int K, int L, int hop, long long kern_sb,
                                    long long bias_sb, cudaStream_t stream) {
  if (B < 1 || B > 65535 || c_in < 1 || K != 3 || L < 1 || hop < 1)
    return (int)cudaErrorInvalidValue;
  switch (c_res) {
    case 4: return launch<3, 8>(x, kern, bias, res, out, B, c_in, L, hop,
                                kern_sb, bias_sb, stream);
    case 8: return launch<3, 16>(x, kern, bias, res, out, B, c_in, L, hop,
                                 kern_sb, bias_sb, stream);
    case 16: return launch<3, 32>(x, kern, bias, res, out, B, c_in, L, hop,
                                  kern_sb, bias_sb, stream);
    case 32: return launch<3, 64>(x, kern, bias, res, out, B, c_in, L, hop,
                                  kern_sb, bias_sb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
