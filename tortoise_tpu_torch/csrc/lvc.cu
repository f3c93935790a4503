// Location-variable convolution + gate + residual (kernel E).
//
// Replaces tortoise_tpu/ops/pallas/lvc.py::lvc_gated_residual: for hop
// chunk l of batch row b,
//   y[o, l*hop + s] = bias[o, l] + sum_{i,k} x[i, l*hop + s + k - pad] * K[i, o, k, l]
//   out[c, t] = residual[c, t] + sigmoid(y[c, t]) * tanh(y[c + C, t])
// with x zero outside [0, T), all in f32.
//
// What bounds it on the card: the predicted kernel, C_in*2C*K*L f32 per
// batch row and conv block (54 MB at the vocoder's widths for 500
// latents), read once whatever the hop. At hop 256 x, the residual and
// the output add 72 MB each and the products (2C*C_in*K = 6144 multiply-
// adds per sample, 3.5 G there) take the f32 FMA units longer than all
// those bytes take the memory.
//
// Design:
// - Work items: one batch row, NL consecutive chunks (8, 16 or 32) and G
//   gated channels (2G outputs: gate c0..c0+G-1 and filter C+c0..). A
//   persistent grid (as many blocks as fit the card) walks the items; a
//   block stages the next item's kernel slices into its second buffer
//   with cp.async while it computes this one.
// - The kernel arrives in its native (B, C_in, 2C, K, L) layout with L
//   contiguous, so an item's rows are NL * 4 = 32 to 128 contiguous bytes,
//   staged as whole 32-byte sectors. Scattered 32-byte rows read at a
//   fraction of the memory's rate, so at small hops an item takes 32
//   chunks (128-byte segments).
// - A thread owns S samples of one chunk and the item's 2G outputs in
//   registers; each weight (a shared load at the same address across the
//   lanes of one chunk) feeds S FMAs. S = 1 or 2 at small hops, where the
//   bytes and not the FMAs bound the kernel: rows land as they are,
//   [i][o][k][chunk], 16-byte copies.
// - The wide path (S = 8, where 256 divides the hop) is bound by its f32
//   FMAs: a warp owns 256 samples of one chunk, a lane 4 at 4 lane and 4
//   at 128 + 4 lane, so x arrives as two coalesced float4 loads a lane and
//   the halos come from the neighbouring lanes by shuffles; rows land with
//   their taps together, [i][o][chunk][4] (4-byte copies), so one 16-byte
//   shared load brings an output's 3 taps for 24 FMAs.
// - x is read one input channel ahead. Items run output group fastest,
//   so the blocks that read the same x run together and x comes from L2
//   after the first of them. The wrapper picks S, NL and G (ops/cuda/
//   lvc.py lvc_plan), shrinking G, then NL, for short inputs (a stream
//   chunk of L = 32) until the items cover the card.
// - The TPU kernel's K pre-shifted copies of x and its chunk-major
//   transposes are not needed.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 3;      // taps

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tt::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tt::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// xv[j] = x[t0 - 1 + j] for j = 0..S+1 (zero outside [0, T)); t0..t0+S-1
// lie in range
template <int S>
__device__ __forceinline__ void load_x(float (&xv)[S + 2], const float* xr,
                                       long long t0, long long T) {
#pragma unroll
  for (int s = 0; s < S; ++s) xv[1 + s] = __ldg(xr + t0 + s);
  xv[0] = t0 > 0 ? __ldg(xr + t0 - 1) : 0.f;
  xv[S + 1] = t0 + S < T ? __ldg(xr + t0 + S) : 0.f;
}

// One input channel's x for a warp's 256 samples from t0 on the wide
// path: a = x[t0 + 4 lane ..], b = x[t0 + 128 + 4 lane ..] (coalesced
// 512-byte rows), and the window's edges x[t0 - 1] (lane 0) and
// x[t0 + 256] (lane 31), zero outside [0, T)
struct XWin {
  float4 a, b;
  float edge;
};
__device__ __forceinline__ XWin load_win(const float* xr, long long t0,
                                         long long T, int lane) {
  XWin w;
  w.a = __ldg(reinterpret_cast<const float4*>(xr + t0) + lane);
  w.b = __ldg(reinterpret_cast<const float4*>(xr + t0 + 128) + lane);
  const long long te = lane == 0 ? t0 - 1 : t0 + 256;
  w.edge = (lane == 0 || lane == 31) && te >= 0 && te < T ? __ldg(xr + te)
                                                          : 0.f;
  return w;
}

template <int S, int G, int NL>
__global__ void __launch_bounds__(kThreads, S * G > 32 ? 1 : 2)
lvc_kernel(const float* __restrict__ x, const float* __restrict__ kern,
           const float* __restrict__ bias, const float* __restrict__ res,
           float* __restrict__ out, int B, int c_in, int C, int L, int hop,
           long long kern_sb, long long bias_sb, int vec) {
  constexpr int OB = 2 * G;          // outputs of the block
  constexpr int kRows = OB * kK;     // kernel rows per input channel
  // the wide path (S = 8) keeps a row's taps together: [i][ol][chunk][4];
  // else rows land as they are: [i][ol][k][chunk]
  constexpr bool kWide = S == 8;
  extern __shared__ float4 sm4[];
  const int tid = threadIdx.x, lane = tid & 31, C2 = 2 * C;
  const long long T = (long long)L * hop;
  // work items (output group, chunk group, batch row), the output group
  // fastest; a block takes items blockIdx.x, + gridDim.x, ... and stages
  // the next one's kernel slices into the other buffer while it computes
  const int n_og = C / G, n_groups = (L + NL - 1) / NL;
  const int n_items = n_og * n_groups * B;
  const int slice = c_in * OB * (kWide ? 4 : kK) * NL;  // floats a buffer

  // stage item's rows: row (i, o, k) holds chunk l at ((i*C2 + o)*K + k)*L + l
  auto stage = [&](int item, float* ws) {
    const int c0 = item % n_og * G, l0 = item / n_og % n_groups * NL;
    const float* kb = kern + (item / (n_og * n_groups)) * kern_sb;
    const int rows = c_in * kRows;
    if (vec && !kWide) {
      constexpr int kParts = NL / 4;  // 16-byte pieces of a row
      for (int e = tid; e < rows * kParts; e += kThreads) {
        const int r = e / kParts, part = e % kParts, rr = r % kRows;
        const int i = r / kRows, ol = rr / kK, k = rr % kK;
        const int o = ol < G ? c0 + ol : C + c0 + ol - G;
        const int l = l0 + 4 * part;
        const float* src = kb + ((size_t)(i * C2 + o) * kK + k) * L + l;
        cp_async16(ws + ((i * OB + ol) * kK + k) * NL + 4 * part,
                   l < L ? src : kb, l < L ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * NL; e += kThreads) {
        const int r = e / NL, q = e % NL, rr = r % kRows;
        const int i = r / kRows, ol = rr / kK, k = rr % kK;
        const int o = ol < G ? c0 + ol : C + c0 + ol - G;
        const float* src = kb + ((size_t)(i * C2 + o) * kK + k) * L + l0 + q;
        cp_async4(kWide ? ws + (((i * OB + ol) * NL + q) << 2) + k
                        : ws + ((i * OB + ol) * kK + k) * NL + q,
                  l0 + q < L ? src : kb, l0 + q < L ? 4 : 0);
      }
    }
  };

  int item = blockIdx.x;
  if (item < n_items) stage(item, reinterpret_cast<float*>(sm4));
  cp_async_commit();
  for (int n = 0; item < n_items; item += gridDim.x, ++n) {
    float* ws = reinterpret_cast<float*>(sm4) + (n & 1) * slice;
    const float4* ws4 = sm4 + (n & 1) * (slice / 4);
    if (item + gridDim.x < n_items)
      stage(item + gridDim.x, reinterpret_cast<float*>(sm4) +
                                  ((n + 1) & 1) * slice);
    cp_async_commit();
    cp_async_wait<1>();  // this item's slices have landed
    __syncthreads();
    const int c0 = item % n_og * G, l0 = item / n_og % n_groups * NL;
    const int b = item / (n_og * n_groups);
    const int span = min(NL, L - l0) * hop;  // samples of the block
    const long long tb = (long long)l0 * hop;
    const float* xb = x + (size_t)b * c_in * T;
    const float* bq = bias + b * bias_sb;
    const int npass = (NL * hop + kThreads * S - 1) / (kThreads * S);
    for (int pass = 0; pass < npass; ++pass) {
      // wide: warp w takes 256 samples (one chunk's, as 256 divides
      // hop), a lane 4 at 4 lane and 4 at 128 + 4 lane; else a thread
      // takes S consecutive samples
      const int p0 = kWide ? pass * kThreads * S + (tid >> 5) * 256
                           : (pass * kThreads + tid) * S;
      const bool active = p0 < span;
      const int q = active ? p0 / hop : 0;  // the chunk (S divides hop)
      const long long t0 = tb + p0;
      float acc[OB][S];
#pragma unroll
      for (int ol = 0; ol < OB; ++ol)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[ol][s] = 0.f;
      float xv[S + 2];
      XWin xw;
      if (active) {
        if constexpr (kWide) xw = load_win(xb, t0, T, lane);
        else load_x<S>(xv, xb, t0, T);
      }
      for (int i = 0; i < c_in; ++i) {
        if (!active) break;
        if constexpr (kWide) {
          XWin xn;
          if (i + 1 < c_in) xn = load_win(xb + (size_t)(i + 1) * T, t0, T, lane);
          // each group's 4 samples with their halos, from the neighbouring
          // lanes (and the other group, across the warp's ends)
          const float la = __shfl_up_sync(0xffffffffu, xw.a.w, 1);
          const float ra = __shfl_down_sync(0xffffffffu, xw.a.x, 1);
          const float lb = __shfl_up_sync(0xffffffffu, xw.b.w, 1);
          const float rb = __shfl_down_sync(0xffffffffu, xw.b.x, 1);
          const float a_end = __shfl_sync(0xffffffffu, xw.a.w, 31);
          const float b_beg = __shfl_sync(0xffffffffu, xw.b.x, 0);
          const float xs[2][6] = {
              {lane == 0 ? xw.edge : la, xw.a.x, xw.a.y, xw.a.z, xw.a.w,
               lane == 31 ? b_beg : ra},
              {lane == 0 ? a_end : lb, xw.b.x, xw.b.y, xw.b.z, xw.b.w,
               lane == 31 ? xw.edge : rb}};
          const float4* w4 = ws4 + (size_t)i * OB * NL + q;
#pragma unroll
          for (int ol = 0; ol < OB; ++ol) {
            const float4 w = w4[ol * NL];  // taps 0, 1, 2
#pragma unroll
            for (int s = 0; s < S; ++s) {
              const float* xg = xs[s >> 2] + (s & 3);
              acc[ol][s] = fmaf(w.x, xg[0], acc[ol][s]);
              acc[ol][s] = fmaf(w.y, xg[1], acc[ol][s]);
              acc[ol][s] = fmaf(w.z, xg[2], acc[ol][s]);
            }
          }
          if (i + 1 < c_in) xw = xn;
        } else {
          float xn[S + 2];
          if (i + 1 < c_in) load_x<S>(xn, xb + (size_t)(i + 1) * T, t0, T);
          const float* w = ws + (size_t)i * kRows * NL + q;
#pragma unroll
          for (int ol = 0; ol < OB; ++ol)
#pragma unroll
            for (int k = 0; k < kK; ++k) {
              const float wv = w[(ol * kK + k) * NL];
#pragma unroll
              for (int s = 0; s < S; ++s)
                acc[ol][s] = fmaf(wv, xv[s + k], acc[ol][s]);
            }
          if (i + 1 < c_in) {
#pragma unroll
            for (int j = 0; j < S + 2; ++j) xv[j] = xn[j];
          }
        }
      }
      if (!active) continue;
      const int l = l0 + q;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float bg = __ldg(bq + (size_t)(c0 + c) * L + l);
        const float bf = __ldg(bq + (size_t)(C + c0 + c) * L + l);
        const size_t row = ((size_t)b * C + c0 + c) * T;
#pragma unroll
        for (int s = 0; s < S; s += kWide ? 4 : 1) {
          if constexpr (kWide) {  // 4 samples at t0 + 128 (s / 4) + 4 lane
            const size_t at = row + t0 + (s >> 2) * 128 + 4 * lane;
            float4 y = __ldg(reinterpret_cast<const float4*>(res + at));
            y.x += tanhf(acc[G + c][s] + bf) / (1.f + expf(-(acc[c][s] + bg)));
            y.y += tanhf(acc[G + c][s + 1] + bf) /
                   (1.f + expf(-(acc[c][s + 1] + bg)));
            y.z += tanhf(acc[G + c][s + 2] + bf) /
                   (1.f + expf(-(acc[c][s + 2] + bg)));
            y.w += tanhf(acc[G + c][s + 3] + bf) /
                   (1.f + expf(-(acc[c][s + 3] + bg)));
            *reinterpret_cast<float4*>(out + at) = y;
          } else {
            const size_t at = row + t0 + s;
            out[at] = __ldg(res + at) + tanhf(acc[G + c][s] + bf) /
                                            (1.f + expf(-(acc[c][s] + bg)));
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged two items on
  }
}

struct Args {
  const float *x, *kern, *bias, *res;
  float* out;
  int B, c_in, C, L, hop;
  long long kern_sb, bias_sb;
};

template <int S, int G, int NL>
int launch(const Args& a, cudaStream_t stream) {
  // two buffers of staged slices: K taps a row, padded to 4 on the wide
  // path
  const size_t smem = 2 * (size_t)a.c_in * 2 * G * (S == 8 ? 4 : kK) * NL *
                      sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static tt::KernelFacts facts;
  const void* fn = reinterpret_cast<const void*>(lvc_kernel<S, G, NL>);
  cudaError_t err = facts.allow_smem(fn);
  // a persistent grid: as many blocks as fit the card, at most one a
  // work item
  int fit = 0;
  if (err == cudaSuccess) err = facts.card_blocks(fn, kThreads, smem, &fit);
  if (err != cudaSuccess) return (int)err;
  const int vec = a.L % 4 == 0 && a.kern_sb % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.kern) % 16 == 0;
  const long long items =
      (long long)(a.C / G) * ((a.L + NL - 1) / NL) * a.B;
  const int grid = (int)std::min(items, (long long)fit);
  lvc_kernel<S, G, NL><<<grid, kThreads, smem, stream>>>(
      a.x, a.kern, a.bias, a.res, a.out, a.B, a.c_in, a.C, a.L, a.hop,
      a.kern_sb, a.bias_sb, vec);
  return (int)cudaGetLastError();
}

// The (S, G, NL) shapes ops/cuda/lvc.py's lvc_plan picks (its
// LVC_SHAPES): S = 1 below hop 64, where a block's 256 threads take 8,
// 16 or 32 chunks in one pass, with 1 or 2 gated channels; S = 2 and the
// wide S = 8 take 8 chunks, with up to 8 and 4 gated channels.
struct Shape {
  int S, G, NL;
  int (*launch)(const Args&, cudaStream_t);
};
constexpr Shape kShapes[] = {
    {1, 1, 8, launch<1, 1, 8>},   {1, 1, 16, launch<1, 1, 16>},
    {1, 1, 32, launch<1, 1, 32>}, {1, 2, 8, launch<1, 2, 8>},
    {1, 2, 16, launch<1, 2, 16>}, {1, 2, 32, launch<1, 2, 32>},
    {2, 1, 8, launch<2, 1, 8>},   {2, 2, 8, launch<2, 2, 8>},
    {2, 4, 8, launch<2, 4, 8>},   {2, 8, 8, launch<2, 8, 8>},
    {8, 1, 8, launch<8, 1, 8>},   {8, 2, 8, launch<8, 2, 8>},
    {8, 4, 8, launch<8, 4, 8>},
};

}  // namespace

// Kernel E. x (B, C_in, T) and residual/out (B, C, T) contiguous f32,
// 16-byte aligned; kernel (B, C_in, 2C, K, L) and bias (B, 2C, L) f32,
// contiguous within a batch row, with batch strides kern_sb / bias_sb
// (elements); T = L*hop, K = 3. S samples a thread, G gated channels
// (dividing C) and NL chunks a work item: one of kShapes, as
// ops/cuda/lvc.py's lvc_plan picks them. Shared memory: two buffers of
// C_in*2G*NL*K f32 (K padded to 4 when S = 8): 96 KB at the vocoder's
// widths.
TT_EXPORT int tt_lvc_gated_residual(const float* x, const float* kern,
                                    const float* bias, const float* res,
                                    float* out, int B, int c_in, int c_res,
                                    int K, int L, int hop, int S, int G,
                                    int NL, long long kern_sb,
                                    long long bias_sb, cudaStream_t stream) {
  if (B < 1 || B > 65535 || c_in < 1 || K != kK || L < 1 || hop < 1 ||
      c_res < 1 || G < 1 || c_res % G || S < 1 || hop % S ||
      (S == 8 && hop % 256) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(res) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{x, kern, bias, res, out, B, c_in, c_res, L, hop, kern_sb,
               bias_sb};
  for (const Shape& s : kShapes)
    if (s.S == S && s.G == G && s.NL == NL) return s.launch(a, stream);
  return (int)cudaErrorInvalidValue;
}
