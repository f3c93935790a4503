// Exact-softmax attention on f32 inputs over strided (B, H, T, D) views
// (every attention kernel on the f32 parity plane), on the tensor cores in
// split TF32 ("3xTF32").
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
// Arithmetic: every f32 operand x of QK^T and PV is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
// away from zero (what cvt.rna.tf32.f32 does), and a product is
// hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22 relative, is dropped): three TF32
// tensor-core products summed in f32, small terms first. One TF32 product
// alone keeps ~3 decimal digits (~4e-4 of max |out| here); the split
// keeps the output within ~5e-6 of max |out| of the f32 reference. The
// tensor cores truncate each sum they add into an accumulator, so P V
// runs into fresh accumulators every key tile and is added to O in f32
// (one accumulator over the whole key loop drifted to 1.4e-5 of max |out|
// at 2176 keys and 4.3e-5 at 8192: scripts/torch_f32_body_variants.py).
//
// What bounds it on the card: 3 x 4*Tq*Tkv*D TF32 FLOPs per (batch,
// head) (495 TFLOP/s dense on an H100, which only wgmma reaches;
// mma.sync gets less), the hi/lo splits (integer and f32 ALU work beside
// every fragment), and Tq*Tkv exps on the MUFU, against a q/k/v read of
// (Tq + 2 Tkv)*D*4 bytes. Measured, the body is latency-bound: every
// S accumulator is a chain of 3*D/8 dependent mma.sync, then the softmax,
// then P V, with 3-4 warps a scheduler to hide it. The design:
// - One block (4 warps) owns 64 query rows of one (b, h); each warp owns
//   16 rows, the M of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. The
//   block walks the keys in tiles of 32 in a 2-stage shared-memory ring
//   filled by cp.async (16 bytes a thread where every base and stride
//   allows it, else 4), the next tile's copy in flight while the warps
//   compute on this one; rows past Tq or Tkv land as zeros. Q's tile
//   lands once and its fragments are reloaded and split every tile
//   (held in registers they cost occupancy and measured slower).
// - Q and K sum over d in another order inside each 8-wide k-step: A
//   (and B) column t stands for d = 2t and column t + 4 for d = 2t + 1,
//   so a thread's two values are one float2 load. Their rows are D + 8
//   floats and V's D + 4, so those 64-bit loads and V's 32-bit loads
//   (rows 2t and 2t + 1, column g) hit distinct banks.
// - S = Q K^T lands in the m16n8 accumulator layout (row g, columns 2t
//   and 2t+1), which is not the TF32 A-fragment layout (row g, columns t
//   and t+4). Instead of moving P between threads, PV sums its 8 keys of
//   a k-step in another order: A column t stands for key 2t and column
//   t+4 for key 2t+1, and V's B fragment reads the same keys (rows 2t and
//   2t+1), so each thread's P registers are its A fragment as they are.
// - The online softmax stays in registers in base 2: a score is
//   (acc * scale + mask + bias) * log2 e and an ex2; the row max and sum
//   reduce over the 4 threads of a row. Mask, Toeplitz bias and a
//   materialized bias are read from global memory (L1/L2 resident: a
//   tile's bias window is 95 floats a head) before the tile's S, so their
//   latency hides behind it, and nothing bounds Tkv. A row with no valid
//   key (every key masked to -1e30) scores every key equally and gives
//   the mean of V, as the Pallas kernels do; a causal row always sees
//   key 0.
// - Causal blocks stop at their diagonal tile, warps whose rows all
//   precede a tile skip it, and the grid runs the longest q tiles first.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 32;           // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

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
  int vec16;  // every base and (b, h, t) stride allows 16-byte copies
};

template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head width 16, 32, 64 or 128");
  static constexpr int kLdQK = D + 8;  // floats a Q or K row in smem
  static constexpr int kLdV = D + 4;   // floats a V row in smem
  static constexpr int kQFloats = kBQ * kLdQK;
  static constexpr int kKFloats = kBK * kLdQK;  // one K tile
  static constexpr int kStageFloats = kKFloats + kBK * kLdV;
  static constexpr int kSmemBytes = 4 * (kQFloats + kStages * kStageFloats);
};

// cvt.rna.tf32.f32 for finite x: the nearest TF32 value, ties away from
// zero (half a TF32 ulp added to the magnitude bits, the 13 low bits
// cleared), in two integer ops; ptxas's cvt measured ~17% slower here
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (to ~2^-22 |x|), both TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16x8 row-major tf32) * b (8x8 column-major tf32), f32 sums
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += (ah + al)(bh + bl) as three TF32 products, small terms first
__device__ __forceinline__ void mma_3x(float c[4], const uint32_t ah[4],
                                       const uint32_t al[4],
                                       const uint32_t bh[2],
                                       const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tt::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tt::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + kRows - 1 of a strided (t, d) f32 view into shared
// memory rows of kLd floats; rows at or past n land as zeros
template <int D, int kRows, int kLd>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int n,
                                          bool vec16) {
  if (vec16) {
    constexpr int kC = D / 4;  // 16-byte chunks a row
#pragma unroll 4
    for (int c = threadIdx.x; c < kRows * kC; c += kThreads) {
      const int r = c / kC, col = (c % kC) * 4;
      const bool ok = r0 + r < n;
      cp_async16(dst + r * kLd + col, src + (ok ? r0 + r : 0) * rs + col, ok);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < kRows * D; c += kThreads) {
      const int r = c / D, col = c % D;
      const bool ok = r0 + r < n;
      cp_async4(dst + r * kLd + col, src + (ok ? r0 + r : 0) * rs + col, ok);
    }
  }
}

// The split fragment of one 8-wide k-step of Q (kRows = 2: an A
// fragment, rows g and g + 8) or K (kRows = 1: a B fragment, row g) from
// shared memory rows of ld floats: p points at row g, column 2t of the
// k-step; column t of the fragment takes d = 2t, column t + 4 d = 2t + 1.
template <int kRows>
__device__ __forceinline__ void load_split(const float* p, int ld,
                                           uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float2 x = *reinterpret_cast<const float2*>(p + 8 * r * ld);
    split(x.x, hi[r], lo[r]);                  // column t
    split(x.y, hi[r + kRows], lo[r + kRows]);  // column t + 4
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_tf32x3(const Args a) {
  using G = Geo<D>;
  constexpr int kLdQK = G::kLdQK, kLdV = G::kLdV;
  constexpr int kNT = kBK / 8;  // n-tiles of S, k-steps of PV
  constexpr int kDT = D / 8;    // k-steps of S, n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* const qsm = smem;
  float* const kv = smem + G::kQFloats;  // stage s: K, then V

  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Tq = a.Tq, Tkv = a.Tkv;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] +
                    h * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] +
                    h * a.vs[1];
  const bool vec16 = a.vec16;
  const int kend_blk = a.causal ? min(Tkv, q0 + kBQ) : Tkv;
  const int ntiles = (kend_blk + kBK - 1) / kBK;

  load_rows<D, kBQ, kLdQK>(qsm, qb, a.qs[2], q0, Tq, vec16);
  load_rows<D, kBK, kLdQK>(kv, kb, a.ks[2], 0, Tkv, vec16);
  load_rows<D, kBK, kLdV>(kv + G::kKFloats, vb, a.vs[2], 0, Tkv, vec16);
  cp_commit();

  const int r0 = warp * 16;  // the warp's first row in the block
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};  // this thread's rows
  int kend[2];
  const float* bias_row[2];  // bias_h + the Toeplitz offset of the row
  const float* full_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kend[r] = a.causal ? min(Tkv, row[r] + 1) : Tkv;
    const int rc = min(row[r], Tq - 1);  // rows past Tq read row Tq - 1
    bias_row[r] = a.bias_vec ? a.bias_vec + (size_t)h * (Tq + Tkv - 1) +
                                   (Tq - 1) - rc
                             : nullptr;
    full_row[r] =
        a.bias_full ? a.bias_full + ((size_t)h * Tq + rc) * Tkv : nullptr;
  }
  const float* mask_b = a.mask ? a.mask + (size_t)b * Tkv : nullptr;
  const bool warp_live = q0 + r0 < Tq;
  const float* qrow = qsm + (r0 + g) * kLdQK + 2 * t;

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_wait_all();
    __syncthreads();  // tile landed; every warp is done with tile - 1
    if (tile + 1 < ntiles) {
      float* nk = kv + ((tile + 1) % kStages) * G::kStageFloats;
      const int n0 = (tile + 1) * kBK;
      load_rows<D, kBK, kLdQK>(nk, kb, a.ks[2], n0, Tkv, vec16);
      load_rows<D, kBK, kLdV>(nk + G::kKFloats, vb, a.vs[2], n0, Tkv, vec16);
    }
    cp_commit();
    const int k0 = tile * kBK;
    if (!warp_live || (a.causal && q0 + r0 + 15 < k0)) continue;
    const float* ksm = kv + (tile % kStages) * G::kStageFloats;
    const float* vsm = ksm + G::kKFloats;

    // the tile's mask + bias a score (element e of an n-tile: row e >> 1,
    // key 2t + (e & 1)), read before S so the loads overlap it
    float add[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int j = min(k0 + 8 * nt + 2 * t + (e & 1), Tkv - 1);
        float x = 0.f;
        if (mask_b) x += __ldg(mask_b + j);
        if (bias_row[r]) x += __ldg(bias_row[r] + j);
        if (full_row[r]) x += __ldg(full_row[r] + j);
        add[nt][e] = x;
      }
    }

    // S = Q K^T for this warp's 16 rows and the tile's kBK keys
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] =
        s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      uint32_t ah[4], al[4];
      load_split<2>(qrow + 8 * kk, kLdQK, ah, al);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh[2], bl[2];
        load_split<1>(ksm + (8 * nt + g) * kLdQK + 8 * kk + 2 * t, kLdQK,
                      bh, bl);
        mma_3x(s[nt], ah, al, bh, bl);
      }
    }

    // online softmax in base 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int j = k0 + 8 * nt + 2 * t + (e & 1);
        const float x = j < kend[r]
                            ? fmaf(s[nt][e], a.scale, add[nt][e]) * kLog2e
                            : -INFINITY;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mb[r] = mn == -INFINITY ? 0.f : mn;  // no valid key yet
      corr[r] = ex2(m[r] - mb[r]);         // 0 while m is -inf
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(s[nt][e] - mb[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }

    // the tile's P V into fresh accumulators, then O = O * corr + P V in
    // f32. k-step kk takes keys 8kk .. 8kk + 7 with A column t as key 2t
    // and column t + 4 as key 2t + 1 (the S accumulator's own registers);
    // V's B fragment reads rows 2t and 2t + 1 to match
    float pv[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);  // row g,     key 2t
      split(s[kk][2], ph[1], pl[1]);  // row g + 8, key 2t
      split(s[kk][1], ph[2], pl[2]);  // row g,     key 2t + 1
      split(s[kk][3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      const float* vr = vsm + (8 * kk + 2 * t) * kLdV + g;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t bh[2], bl[2];
        split(vr[8 * dt], bh[0], bl[0]);
        split(vr[kLdV + 8 * dt], bh[1], bl[1]);
        mma_3x(pv[dt], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = fmaf(o[dt][e], corr[e >> 1], pv[dt][e]);
  }

  float* ob = static_cast<float*>(a.out) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = ob + row[r] * a.os[2] + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      orow[8 * dt] = o[dt][2 * r] * inv;
      orow[8 * dt + 1] = o[dt][2 * r + 1] * inv;
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  static tt::KernelFacts facts;
  const cudaError_t err =
      facts.allow_smem(reinterpret_cast<const void*>(attn_tf32x3<D>));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, B);
  attn_tf32x3<D><<<grid, kThreads, Geo<D>::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels B, C, D1 and D2 on f32 inputs. q (B, H, Tq, D), k and v
// (B, H, Tkv, D) as strided f32 views (d contiguous); strides[12] =
// element strides of (b, h, t) for q, k, v, out; out (B, H, Tq, D) f32.
// bias_vec (H, Tq + Tkv - 1), bias_full (H, Tq, Tkv) and mask (B, Tkv)
// are f32 or null. Any Tkv; any strides (16-byte copies where the bases
// and strides allow them).
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
  bool vec16 = (reinterpret_cast<uintptr_t>(q) |
                reinterpret_cast<uintptr_t>(k) |
                reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int x = 0; x < 3; ++x) {
    a.qs[x] = strides[x];
    a.ks[x] = strides[3 + x];
    a.vs[x] = strides[6 + x];
    a.os[x] = strides[9 + x];
    vec16 = vec16 && a.qs[x] % 4 == 0 && a.ks[x] % 4 == 0 && a.vs[x] % 4 == 0;
  }
  a.H = H;
  a.Tq = Tq;
  a.Tkv = Tkv;
  a.bias_vec = bias_vec;
  a.bias_full = bias_full;
  a.mask = mask;
  a.scale = scale;
  a.causal = causal;
  a.vec16 = vec16;
  switch (D) {
    case 16: return launch<16>(a, B, stream);
    case 32: return launch<32>(a, B, stream);
    case 64: return launch<64>(a, B, stream);
    case 128: return launch<128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
