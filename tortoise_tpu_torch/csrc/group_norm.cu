// The denoiser's group norm and the elementwise chain after it (kernel G).
//
// Replaces no Pallas kernel: the JAX package leaves
// tortoise_tpu/ops/basic.py::group_norm_tc, and the FiLM, SiLU and mask
// that tortoise_tpu/models/diffusion.py applies after it, to XLA, which
// fuses them. Eagerly on the card that chain was ~15-20 kernels a call,
// 46 calls a denoiser eval. Over a time-major (B, T, C) map with G
// groups of C/G channels:
//   y = (x - mean[b, g]) * rstd[b, g] * w[c] + bias[c], 0 on padded frames
//   y = y * (1 + scale[b, c]) + shift[b, c]          (FiLM, optional;
//                                  1 + scale rounded to x's type, as the
//                                  JAX package forms it in bf16)
//   y = silu(y), 0 on padded frames                  (optional)
// all in f32, rounded once to x's type. The statistics of (b, g)
// run over its valid frames (mask true) and the group's channels: on a
// bf16 map in one pass, E[x^2] - mean^2 clamped at 0 (the JAX package's
// `fast` form); on an f32 map the exact centered form, two passes over
// each chunk of rows merged by Chan's formula.
//
// What bounds it: bytes. A bf16 (2, 2176, 1024) map is read twice (the
// second read mostly from the 50 MB L2, which still holds it) and written
// once: 8.9 MB from and 8.9 MB to device memory, ~5 us at 3.35 TB/s.
//
// Design: two launches over one grid, (chunk of rows, batch row), sized
// by ops/cuda/group_norm.py's gn_plan to about two blocks an SM whatever
// B and T (64 blocks of one (row, group) each would not fill the card).
// - gn_stats: a block reads whole rows of its chunk, 16 bytes a thread,
//   coalesced along C, eight rows in flight (the mask bytes beside them).
//   Each channel's rows go into kAcc interleaved sums, which shared
//   memory takes to one value a group, and the block writes its chunk's
//   partials (valid rows, sum, and the sum of squares or the centered M2)
//   for every group.
// - gn_apply: each block first stages its batch row's chunk partials in
//   shared memory (16-byte loads, all in flight at once) and merges them
//   into (mean, rstd) per group (every block of the row computes the same
//   bits), then walks its chunk's rows doing the affine, FiLM, SiLU and
//   mask in registers and writing the output once.
// - Sums meet in an order that reads neither C nor G: rows by the kAcc
//   interleaved sums of chunks that gn_plan cuts from B and T alone,
//   channels by up to kSumLanes lanes a group (sum_lanes(C / G)), chunks
//   by kSumLanes lanes. So a tp rank's local groups give the bits of the
//   single rank's call (a first design, whose row slots followed C and
//   lanes G, put 2.4% between the two ranks' denoiser eval and one
//   rank's). Nothing is summed by atomics: a call repeats bit for bit,
//   in a CUDA graph as eagerly.
// - Lanes share a group's sums: a warp a group, group after group, was the
//   merge's largest cost (~5 us of a 27 us call at the denoiser's map).
//   The SiLU takes __expf and __fdividef: the precise pair cost another
//   ~1.3 us there.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // ops/cuda/group_norm.py GN_THREADS
constexpr int kAcc = 4;        // interleaved row sums a channel and chunk
constexpr int kSumLanes = 8;   // lanes a group takes in the sums (at most)
// gn_apply stages a row's partials beside its 2G statistics when they fit
// in this much dynamic shared memory (48 KB), else reads them in place
constexpr int kSmemFloats = 12288;

// 16 bytes of the input type, kV channels a thread, loaded raw and
// widened to f32 when used
template <typename T>
struct In;
template <>
struct In<__nv_bfloat16> {
  static constexpr int kV = 8;
  __device__ static __forceinline__ void unpack(const uint4& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct In<float> {
  static constexpr int kV = 4;
  __device__ static __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v as a value of type T (round to nearest even)
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (sizeof(T) == 2) return tt::bf16_round(v);
  return v;
}

// 16 bytes of x's type stored at p
__device__ __forceinline__ void store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(tt::pack_bf16(v[0], v[1]), tt::pack_bf16(v[2], v[3]),
                 tt::pack_bf16(v[4], v[5]), tt::pack_bf16(v[6], v[7]));
}

struct Geo {
  int B, T, C, G, chunk, n_chunks;
  long long mask_sb;  // the mask's batch stride (0: one row for all)
};

// n_chunks rounded up to whole 16-byte vectors: the partials' row length
__host__ __device__ __forceinline__ int chunks4(const Geo& g) {
  return (g.n_chunks + 3) & ~3;
}

// partials of batch row b, each chunks4 long: valid rows, then the G
// groups' sums, then the G groups' second sums
__device__ __forceinline__ float* part_row(float* part, const Geo& g, int b) {
  return part + (size_t)b * (2 * g.G + 1) * chunks4(g);
}

// v summed over the n lanes of a group (consecutive lanes, n a power of
// two up to 32): every lane gets the same bits
__device__ __forceinline__ float lanes_sum(float v, int n) {
  for (int o = n >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lanes a group takes in the chunk's group sums: a power of two, at most
// kSumLanes and at most cg. It depends on cg alone, as kSumLanes is the
// merge's, so the sums meet in the same order whatever G and C (a tp
// rank's local groups give the single rank's bits).
__device__ __forceinline__ int sum_lanes(int cg) {
  int n = kSumLanes;
  while (n > cg) n >>= 1;
  return n;
}

// One value a group from red[kAcc][C], the chunk's kAcc interleaved row
// sums of each channel: a channel's sums pairwise, then its group's
// channels over sum_lanes(cg) lanes in channel order, then lanes_sum.
__device__ __forceinline__ void group_sums(const float* red, const Geo& g,
                                           float* out) {
  static_assert(kAcc == 4, "the pairwise channel sum below takes 4 sums");
  const int cg = g.C / g.G, n = sum_lanes(cg);
  for (int base = 0; base < g.G * n; base += kThreads) {
    const int slot = base + threadIdx.x, gi = slot / n, sub = slot % n;
    float acc = 0.f;
    if (gi < g.G)
      for (int c = gi * cg + sub; c < (gi + 1) * cg; c += n)
        acc += (red[c] + red[g.C + c]) + (red[2 * g.C + c] + red[3 * g.C + c]);
    acc = lanes_sum(acc, n);
    if (gi < g.G && sub == 0) out[gi] = acc;
  }
}

// The chunk [t0, t1)'s rows in the order every C and G shares: channel
// sum a (< kAcc) takes rows t0 + a, t0 + a + kAcc, ... in turn, and this
// thread (row slot r of rpi <= kAcc) owns the NS sums r, r + rpi, ...
// (NS = ceil(kAcc / rpi)). fn(i, v, valid) for the thread's i-th sum,
// eight rows in flight (four with four sums: eight spilled or slowed the
// f32 pass), an invalid row's v zeros.
template <int NS, typename T, typename Fn>
__device__ __forceinline__ void walk_sums(const T* xb, const uint8_t* mb,
                                          int C, int t0, int t1, int r,
                                          int rpi, Fn fn) {
  constexpr int V = In<T>::kV, kUnroll = NS == 4 ? 1 : 8 / NS;
  if (r >= rpi) return;
  for (int base = t0; base < t1; base += kAcc * kUnroll) {
    uint4 raw[kUnroll][NS];
    bool ok[kUnroll][NS];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int t = base + u * kAcc + r + i * rpi;
        if (r + i * rpi < kAcc && t < t1)
          raw[u][i] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)t * C));
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int t = base + u * kAcc + r + i * rpi;
        ok[u][i] = t < t1 && (mb == nullptr || mb[t]);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int t = base + u * kAcc + r + i * rpi;
        if (r + i * rpi >= kAcc || t >= t1) continue;
        float v[V];
        if (ok[u][i]) {
          In<T>::unpack(raw[u][i], v);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = 0.f;
        }
        fn(i, v, ok[u][i]);
      }
  }
}

// x's rows [t0, t1) of batch row b, kUnroll rows in flight (their mask
// bytes read beside them, not before): fn(v, valid, t) for each row this
// thread takes (rows t0 + r, t0 + r + rpi, ...), in order; an invalid
// row's v is zeros
template <int kUnroll, typename T, typename Fn>
__device__ __forceinline__ void walk_rows(const T* xb, const uint8_t* mb,
                                          int C, int t0, int t1, int r,
                                          int rpi, Fn fn) {
  constexpr int V = In<T>::kV;
  for (int t = t0 + r; t < t1; t += kUnroll * rpi) {
    uint4 raw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tu = t + u * rpi;
      if (tu < t1)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)tu * C));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tu = t + u * rpi;
      ok[u] = tu < t1 && (mb == nullptr || mb[tu]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tu = t + u * rpi;
      if (tu >= t1) break;
      float v[V];
      if (ok[u]) {
        In<T>::unpack(raw[u], v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
      fn(v, ok[u], tu);
    }
  }
}

template <typename T, bool kExact, int NS>
__global__ void __launch_bounds__(kThreads, 2)
    gn_stats(const T* __restrict__ x, const uint8_t* __restrict__ mask,
             Geo g, float* __restrict__ part) {
  constexpr int V = In<T>::kV;
  // red[kAcc][C]; the G group values; valid rows of each row sum
  extern __shared__ float sm[];
  const int tpr = g.C / V, rpi = min(kThreads / tpr, kAcc);
  const int tid = threadIdx.x, r = tid / tpr, c0 = (tid % tpr) * V;
  const int cg = g.C / g.G, b = blockIdx.y, k = blockIdx.x;
  const int nk4 = chunks4(g);
  const int t0 = k * g.chunk, t1 = min(t0 + g.chunk, g.T);
  const T* xb = x + (size_t)b * g.T * g.C + c0;
  const uint8_t* mb = mask ? mask + b * g.mask_sb : nullptr;
  float* red = sm;
  float* gv = red + kAcc * g.C;
  int* rows_ok = reinterpret_cast<int*>(gv + g.G);
  float* pb = part_row(part, g, b);
  // this thread's row sums i: red row r + i * rpi
  auto to_red = [&](const float (&s)[NS][V]) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (r < rpi && r + i * rpi < kAcc)
#pragma unroll
        for (int j = 0; j < V; ++j) red[(r + i * rpi) * g.C + c0 + j] = s[i][j];
  };

  float s1[NS][V], s2[NS][V];
  int n_ok[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    n_ok[i] = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) s1[i][j] = s2[i][j] = 0.f;
  }
  walk_sums<NS, T>(xb, mb, g.C, t0, t1, r, rpi, [&](int i, const float* v,
                                                    bool ok) {
    n_ok[i] += ok;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[i][j] += v[j];
      if constexpr (!kExact) s2[i][j] = fmaf(v[j], v[j], s2[i][j]);
    }
  });
  to_red(s1);
  if (c0 == 0 && r < rpi)
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (r + i * rpi < kAcc) rows_ok[r + i * rpi] = n_ok[i];
  __syncthreads();
  group_sums(red, g, gv);
  int n = 0;  // valid rows of the chunk
  for (int i = 0; i < kAcc; ++i) n += rows_ok[i];
  __syncthreads();
  if (tid == 0) pb[k] = (float)n;
  for (int gi = tid; gi < g.G; gi += kThreads) pb[(1 + gi) * nk4 + k] = gv[gi];

  if constexpr (kExact) {
    // the chunk's M2 about its own group means
    const float cnt = fmaxf((float)n * cg, 1.f);
    float m[V];
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = gv[(c0 + j) / cg] / cnt;
    walk_sums<NS, T>(xb, mb, g.C, t0, t1, r, rpi, [&](int i, const float* v,
                                                      bool ok) {
      if (!ok) return;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - m[j];
        s2[i][j] = fmaf(d, d, s2[i][j]);
      }
    });
  }
  __syncthreads();  // gv and red are read
  to_red(s2);
  __syncthreads();
  group_sums(red, g, gv);
  __syncthreads();
  for (int gi = tid; gi < g.G; gi += kThreads)
    pb[(1 + g.G + gi) * nk4 + k] = gv[gi];
}

template <typename TIn, bool kExact>
__global__ void __launch_bounds__(kThreads, 2)
    gn_apply(const TIn* __restrict__ x, const uint8_t* __restrict__ mask,
             Geo g, const float* __restrict__ part,
             const float* __restrict__ w, const float* __restrict__ bias,
             const TIn* __restrict__ scale, const TIn* __restrict__ shift,
             long long film_sb, float eps, int silu, TIn* __restrict__ out) {
  constexpr int V = In<TIn>::kV;
  extern __shared__ float sm[];  // mean[G], rstd[G], the row's partials
  const int tpr = g.C / V, rpi = kThreads / tpr, tid = threadIdx.x;
  const int r = tid / tpr, c0 = (tid % tpr) * V, cg = g.C / g.G;
  const int b = blockIdx.y, k = blockIdx.x, nk = g.n_chunks;
  const int nk4 = chunks4(g);

  // the row's partials, staged in shared memory (16-byte loads, all of a
  // thread's in flight at once) when they fit beside the statistics
  const float* pb = part_row(const_cast<float*>(part), g, b);
  const int total4 = (2 * g.G + 1) * nk4 / 4;
  if (2 * g.G + 4 * total4 <= kSmemFloats) {
    float4* dst = reinterpret_cast<float4*>(sm + 2 * g.G);
    const float4* src = reinterpret_cast<const float4*>(pb);
#pragma unroll 8
    for (int i = tid; i < total4; i += kThreads) dst[i] = __ldg(src + i);
    pb = sm + 2 * g.G;
    __syncthreads();
  }
  // the row's statistics from its chunks' partials: kSumLanes lanes a
  // group, each over its chunks in turn, then lanes_sum (the same order
  // whatever G and C)
  for (int base = 0; base < g.G * kSumLanes; base += kThreads) {
    const int slot = base + tid, gi = slot / kSumLanes;
    const int sub = slot % kSumLanes;
    const bool act = gi < g.G;
    float n = 0.f, s = 0.f;
    if (act)
      for (int i = sub; i < nk; i += kSumLanes) {
        n += pb[i];
        s += pb[(1 + gi) * nk4 + i];
      }
    n = lanes_sum(n, kSumLanes);
    s = lanes_sum(s, kSumLanes);
    const float cnt = fmaxf(n * cg, 1.f), mean = s / cnt;
    float q = 0.f;
    if (act)
      for (int i = sub; i < nk; i += kSumLanes) {
        const float qi = pb[(1 + g.G + gi) * nk4 + i];
        if constexpr (kExact) {
          // Chan: M2 = sum M2_i + n_i (mean_i - mean)^2
          const float ni = pb[i] * cg;
          const float di = pb[(1 + gi) * nk4 + i] / fmaxf(ni, 1.f) - mean;
          q += ni > 0.f ? fmaf(ni * di, di, qi) : 0.f;
        } else {
          q += qi;
        }
      }
    q = lanes_sum(q, kSumLanes);
    const float var = kExact ? q / cnt : fmaxf(q / cnt - mean * mean, 0.f);
    if (act && sub == 0) {
      sm[gi] = mean;
      sm[g.G + gi] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  if (r >= rpi) return;

  float mu[V], a[V], bb[V], fs[V], ft[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j, gi = c / cg;
    mu[j] = sm[gi];
    a[j] = sm[g.G + gi] * __ldg(w + c);
    bb[j] = __ldg(bias + c);
    fs[j] = scale ? round_as<TIn>(1.f + to_f32(scale[b * film_sb + c]))
                  : 1.f;
    ft[j] = scale ? to_f32(shift[b * film_sb + c]) : 0.f;
  }
  const int t0 = k * g.chunk, t1 = min(t0 + g.chunk, g.T);
  const TIn* xb = x + (size_t)b * g.T * g.C + c0;
  TIn* ob = out + (size_t)b * g.T * g.C + c0;
  const uint8_t* mb = mask ? mask + b * g.mask_sb : nullptr;
  walk_rows<4, TIn>(xb, mb, g.C, t0, t1, r, rpi, [&](const float* v, bool ok,
                                                     int t) {
    float y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float e = ok ? fmaf(v[j] - mu[j], a[j], bb[j]) : 0.f;
      e = fmaf(e, fs[j], ft[j]);
      if (silu) e = ok ? __fdividef(e, 1.f + __expf(-e)) : 0.f;
      y[j] = e;
    }
    store(ob + (size_t)t * g.C, y);
  });
}

template <typename T>
int launch(const void* x, const uint8_t* mask, const Geo& g, float* part,
           const float* w, const float* bias, const void* scale,
           const void* shift, long long film_sb, float eps, int silu,
           void* out, cudaStream_t stream) {
  constexpr bool kExact = sizeof(T) == 4;
  const dim3 grid(g.n_chunks, g.B);
  const size_t stats_smem = (kAcc * g.C + g.G + kAcc) * sizeof(float);
  // the row sums a thread owns: kAcc over the row slots a block has
  const int rpi = min(kThreads / (g.C / In<T>::kV), kAcc);
  const int ns = (kAcc + rpi - 1) / rpi;
  if (ns == 1)
    gn_stats<T, kExact, 1><<<grid, kThreads, stats_smem, stream>>>(
        static_cast<const T*>(x), mask, g, part);
  else if (ns == 2)
    gn_stats<T, kExact, 2><<<grid, kThreads, stats_smem, stream>>>(
        static_cast<const T*>(x), mask, g, part);
  else
    gn_stats<T, kExact, 4><<<grid, kThreads, stats_smem, stream>>>(
        static_cast<const T*>(x), mask, g, part);
  const int staged = 2 * g.G + (2 * g.G + 1) * chunks4(g);
  gn_apply<T, kExact>
      <<<grid, kThreads, (staged <= kSmemFloats ? staged : 2 * g.G) *
                             sizeof(float), stream>>>(
          static_cast<const T*>(x), mask, g, part, w, bias,
          static_cast<const T*>(scale), static_cast<const T*>(shift),
          film_sb, eps, silu, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel G. x and out (B, T, C) contiguous, bf16 (is_f32 = 0) or f32,
// 16-byte aligned. mask: bytes (0/1) of (B, T) with batch stride mask_sb
// (0: one row for every b), or null. w, bias: (C,) f32. scale, shift:
// FiLM rows of C values of x's type at batch stride film_sb, or both
// null. part: (B, 2G + 1, n4) f32 scratch, n4 = n_chunks rounded up to a
// multiple of 4; chunk rows a block, n_chunks = ceil(T / chunk), as
// gn_plan sets them. Needs C a multiple of the 16-byte vector (8 bf16, 4
// f32), at most 256 vectors, and G dividing C, at most kSmemFloats / 2.
TT_EXPORT int tt_group_norm_act(const void* x, int is_f32, const uint8_t* mask,
                                long long mask_sb, const float* w,
                                const float* bias, const void* scale,
                                const void* shift, long long film_sb,
                                float* part, void* out, int B, int T, int C,
                                int G, int chunk, int n_chunks, float eps,
                                int silu, cudaStream_t stream) {
  const int V = is_f32 ? 4 : 8;
  if (B < 1 || B > 65535 || T < 1 || C < V || C % V || C / V > kThreads ||
      G < 1 || C % G || chunk < 1 || n_chunks < 1 ||
      (long long)chunk * n_chunks < T ||
      (long long)chunk * (n_chunks - 1) >= T || 2 * G > kSmemFloats ||
      (scale == nullptr) != (shift == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const Geo g{B, T, C, G, chunk, n_chunks, mask_sb};
  return is_f32 ? launch<float>(x, mask, g, part, w, bias, scale, shift,
                                film_sb, eps, silu, out, stream)
                : launch<__nv_bfloat16>(x, mask, g, part, w, bias, scale,
                                        shift, film_sb, eps, silu, out,
                                        stream);
}
