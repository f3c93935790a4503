// Exact-softmax attention on wgmma + TMA: every bf16 attention kernel.
//
// Replaces tortoise_tpu/ops/pallas/flash_attention.py:
//   B  flash_attention_packed      — non-causal, per-head-interleaved qkv
//      (c = h*3D + part*D + d), T5 rel-pos bias, additive key mask;
//   C  flash_attention_causal_qkv  — causal, part-major qkv
//      (c = part*H*D + h*D + d), additive key mask;
//   D1 _grouped_flash / _attn_kernel_rowblock — the band-bias body of
//      flash_attention over (B, H, T, D): non-causal, Tq == Tkv, T5 bias,
//      key mask, output in q's dtype (here bf16);
//   D2 _attn_kernel — flash_attention's generic body: Tq and Tkv free, no
//      bias, a Toeplitz (bucket or formula) bias or a materialized
//      (H, Tq, Tkv) bias, a key mask, an optional causal flag (top-left:
//      key j is seen by row i when j <= i), output f32.
// All are one function on (B, H, T, D) operands. The generic body
// (attn_kernel) reads q, k and v as strided views (d contiguous) of the
// caller's memory, each through a tensor map of its own, so views of a
// fused qkv need no copy. It runs every bf16 call at head widths 16, 32,
// 64 and 128, except B and C at width 64, which keep qkv_kernel: the same
// design over one map of the fused qkv (see its note). f32 inputs run the
// FMA body of flash_attention_bhtd.cu.
//
// What bounds it on the card: ~4*Tq*Tkv*D FLOPs per (batch, head) on the
// tensor cores (QK^T and PV) and Tq*Tkv exps on the MUFU, against a q/k/v
// read of only (Tq + 2 Tkv)*D bf16. At head width 64 the two are about
// equal; at widths 16 and 32 the exps bound it, so the score epilogue is
// kept lean: one FFMA, an add and an ex2 a score. A materialized bias
// (4 bytes a score) makes the call bound by its bytes.
//
// Design (Hopper, head width D in {16, 32, 64, 128}): one block owns 128
// query rows of one (batch, head) and walks the keys in 64-key tiles.
// - A producer warp issues TMA loads: the Q tile once, then K and V tiles
//   into a 3-stage shared-memory ring guarded by mbarriers (full: the
//   tile's bytes landed; empty: all 8 consumer warps are done with it).
//   Each operand has a 4-D map over its view, dims sorted by stride (d
//   first); q's runs over Tq rows, k's and v's over Tkv. A tile is a box
//   of 64 rows of min(D, 64) columns, and rows past the end read as
//   zeros. Rows of 32 bytes (D = 16) take the 32-byte swizzle, 64 bytes
//   (D = 32) the 64-byte one, 128 bytes the 128-byte one; D = 128 loads
//   two 64-column boxes per tile. The swizzled box is the layout wgmma
//   reads.
// - Two consumer warpgroups own 64 query rows each. S = Q K^T runs as
//   D/16 wgmma.m64n64k16 with Q and K from shared memory; the online
//   softmax stays in registers; O += P V runs as 4 key steps of
//   wgmma.m64n{16,32,64}k16 (one per 64-column box) with P from
//   registers (the S accumulator's layout is the A-fragment layout) and V
//   from shared memory read MN-major (the B-operand transpose).
// - The softmax is in base 2. The additive key mask (-inf past Tkv) and
//   a Toeplitz bias window (the Tkv + 129 deltas j - i this block can
//   see) are staged once a block, already times log2 e, so a score is one
//   FFMA (s * scale log2 e + mask + bias) and an ex2. The window is kept
//   twice, the second copy one delta ahead, so every thread reads its
//   (bias, bias) pairs as aligned 8-byte loads; a row's pair for key
//   chunk c is the next row half's pair for chunk c + 1. The window
//   bounds Tkv (smem_bytes; the wrapper names the limit).
// - A materialized bias (kFullBias) is read from global memory as 8-byte
//   pairs in the accumulator's layout, into registers one tile ahead (at
//   width 128 at the tile's start: the registers), so its latency hides
//   behind a tile's work; that mode runs one block an SM (the registers)
//   and orders its grid (q tile, b, h) so a head's blocks for every batch
//   row run together and read its bias from L2.
// - Each warpgroup waits for its QK^T before the softmax and for its PV
//   before the next tile; the two warpgroups of a block and the two
//   blocks of an SM interleave on the tensor cores and the MUFU. P stays
//   f32 in the score registers and is packed to bf16 for PV. (Issuing
//   tile t's QK^T and tile t-1's PV together, the softmax of t between
//   them, measured slower at every width: it spills at the 96 registers
//   two blocks of 288 threads leave a thread.)
// - Causal blocks stop at their diagonal: tiles above it are never
//   loaded, and a warpgroup skips the last tile when all its rows
//   precede it.
//
// Numerics follow the Pallas kernels: bf16 q/k/v, f32 scores, the
// softmax weights rounded to bf16 before the PV product, f32 normaliser
// summed from the unrounded weights, output rounded to bf16 (B, C, D1) or
// kept f32 (D2). The Toeplitz bias arrives as a per-head vector
// bias[h, (j - i) + Tq - 1] (the bucket ids depend only on j - i); the
// mask as an additive 0 / -1e30 row per batch row.
#include "common.cuh"

namespace {

constexpr int kBQ = 128;           // query rows per block (2 warpgroups)
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kStages = 3;         // K/V ring depth
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;  // the card's per-block opt-in

// the bias a score gets (a template parameter of the generic body)
enum BiasMode : int {
  kNoBias = 0,    // none: the window is neither staged nor read
  kVecBias = 1,   // a per-head Toeplitz vector (H, Tq + Tkv - 1) or zeros
  kFullBias = 2,  // a materialized (H, Tq, ld) f32 bias
};

template <int D>
struct Geo {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head width 16, 32, 64 or 128");
  static constexpr int kBW = D < 64 ? D : 64;       // columns of one box
  static constexpr int kNB = D / kBW;               // boxes across a row
  static constexpr int kBoxBytes = kBK * kBW * 2;   // 64 rows of one box
  static constexpr int kTileBytes = kNB * kBoxBytes;
  // shared-memory layout (offsets from a 1024-byte aligned base)
  static constexpr int kOffK = 2 * kTileBytes;      // after 2 x 64 Q rows
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  static constexpr int kOffF32 = kOffBar + 128;     // bias windows, mask
  static constexpr int kMinBlocks = D > 64 ? 1 : 2;  // per SM (registers)
};

// wgmma shared-memory descriptor of a box of 64 rows of kBW bf16 in the
// swizzle of its row width (128, 64 or 32 bytes). The K-major operands
// (Q, K) and the MN-major V (whose N, the box's width, fits in one
// swizzle row) share it.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return tt::wgmma_desc<Geo<D>::kBW * 2>(p);
}

#define TT_ACC8(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7])
#define TT_ACC16(d)                                                         \
  TT_ACC8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),             \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TT_ACC32(d)                                                         \
  TT_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define TT_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define TT_REGS16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
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

// d += A (registers) * B (smem, MN-major: the transposed B operand),
// 64 x N x 16 for N = 64, 32 or 16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " TT_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " TT_REGS8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : TT_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

using tt::pack_bf16;

// 2^x on the MUFU (scores are kept in log2 units: e^s = 2^(s log2 e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one warpgroup's 64 rows and one 64-key tile, issued and
// committed (not waited for; the caller fences first)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint8_t* qt,
                                         const uint8_t* kt) {
  constexpr int kSteps = Geo<D>::kBW / 16;  // k-steps inside one box
  const uint64_t dq = smem_desc<D>(qt), dk = smem_desc<D>(kt);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = ((kk / kSteps) * Geo<D>::kBoxBytes + (kk % kSteps) * 32) >> 4;
    wgmma_ss(s, dq + off, dk + off, kk);
  }
  tt::wgmma_commit();
}

// O += P V over one 64-key tile, issued and committed (not waited for;
// the caller fences first)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[Geo<D>::kNB][Geo<D>::kBW / 2], const uint32_t (&pa)[4][4],
    const uint8_t* vt) {
  const uint64_t dv = smem_desc<D>(vt);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // over the tile's keys, 16 at a time
#pragma unroll
    for (int nb = 0; nb < Geo<D>::kNB; ++nb)
      wgmma_rs(o[nb], pa[kk],
               dv + ((nb * Geo<D>::kBoxBytes + kk * 16 * Geo<D>::kBW * 2) >> 4));
  tt::wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fence_out(
    float (&o)[Geo<D>::kNB][Geo<D>::kBW / 2]) {
#pragma unroll
  for (int nb = 0; nb < Geo<D>::kNB; ++nb) tt::fence_regs(o[nb]);
}

// This thread's materialized-bias pairs of one 64-key tile: bf[c][hf] is
// (row r0 + 8 hf; keys j + 8c, j + 8c + 1), j = j0 + 2tg; p points at
// (row r0, key j), rows ld floats apart; rows past Tq and keys past Tkv
// read as 0 (their scores are masked anyway)
__device__ __forceinline__ void load_bias(float2 (&bf)[8][2], const float* p,
                                          long long ld, bool row0, bool row1,
                                          int j, int Tkv) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool key = j + 8 * c < Tkv;
    bf[c][0] = row0 && key ? __ldg(reinterpret_cast<const float2*>(p + 8 * c))
                           : make_float2(0.f, 0.f);
    bf[c][1] = row1 && key
                   ? __ldg(reinterpret_cast<const float2*>(p + 8 * ld + 8 * c))
                   : make_float2(0.f, 0.f);
  }
}

// what a score adds to s * scale * log2 e: the mask, plus the window's
// bias (kVecBias) or the materialized bias times log2 e (kFullBias)
template <int kBias>
__device__ __forceinline__ float score_add(float mask, float window,
                                           float full) {
  return kBias == kVecBias    ? mask + window
         : kBias == kFullBias ? fmaf(full, kLog2e, mask)
                              : mask;
}

// The online-softmax update of one 64-key tile. s is the m64n64
// accumulator: s[4c + 2hf + e] is row r0 + 8 hf, key j0 + 8c + 2tg + e.
// kVecBias: bp points at this thread's window pair of key 2tg, row r0 in
// tile 0 (pairs of row r0 + 8 and chunk c are the row-r0 pairs of chunk
// c - 1). kFullBias: bf holds the tile's bias pairs (load_bias). mp points
// at the mask pair of key 2tg. Returns the factor the running output must
// be scaled by (per row half); s is left holding the unrounded softmax
// weights P.
template <bool kCausal, int kBias>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], const float* bp, const float2 (&bf)[8][2],
    const float* mp, int j0, int r0, int tg, float sl2, float (&m)[2],
    float (&l)[2], float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
  float2 prev = kBias == kVecBias
                    ? *reinterpret_cast<const float2*>(bp + j0 - 8)
                    : make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 cur = kBias == kVecBias
                           ? *reinterpret_cast<const float2*>(bp + j0 + 8 * c)
                           : make_float2(0.f, 0.f);
    const float2 mk = *reinterpret_cast<const float2*>(mp + j0 + 8 * c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 bv = hf ? prev : cur;
      float v0 = fmaf(s[4 * c + 2 * hf], sl2,
                      score_add<kBias>(mk.x, bv.x, bf[c][hf].x));
      float v1 = fmaf(s[4 * c + 2 * hf + 1], sl2,
                      score_add<kBias>(mk.y, bv.y, bf[c][hf].y));
      if (kCausal) {
        const int row = r0 + 8 * hf, j = j0 + 8 * c + 2 * tg;
        if (j > row) v0 = -INFINITY;
        if (j + 1 > row) v1 = -INFINITY;
      }
      s[4 * c + 2 * hf] = v0;
      s[4 * c + 2 * hf + 1] = v1;
      mx[hf] = fmaxf(mx[hf], fmaxf(v0, v1));
    }
    prev = cur;
  }
  float mb[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float mn = fmaxf(m[hf], mx[hf]);
    mb[hf] = mn == -INFINITY ? 0.f : mn;  // no valid key yet
    corr[hf] = ex2(m[hf] - mb[hf]);       // 0 while m is -inf
    l[hf] *= corr[hf];
    m[hf] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hf = (i >> 1) & 1;
    s[i] = ex2(s[i] - mb[hf]);
    l[hf] += s[i];
  }
}

// P (bf16) as the A operand of the 4 key steps of PV
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    // S chunk c = i / 4 covers keys 8c..8c+7: key step c / 2, register
    // (row half) + 2 * (second 8 keys of the step)
    pa[i >> 3][((i >> 1) & 1) + 2 * ((i >> 2) & 1)] = pack_bf16(s[i], s[i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(
    float (&o)[Geo<D>::kNB][Geo<D>::kBW / 2], const float (&corr)[2]) {
#pragma unroll
  for (int nb = 0; nb < Geo<D>::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < Geo<D>::kBW / 2; ++i) o[nb][i] *= corr[(i >> 1) & 1];
}

// the coordinate of map slot `slot` (1..3): the one of t, h, b placed there
__device__ __forceinline__ int coord(int perm, int slot, int t, int h, int b) {
  return (perm & 3) == slot ? t : ((perm >> 2) & 3) == slot ? h : b;
}

// one box (64 rows from t0, columns d0..) of head h, batch row b
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         int perm, uint64_t* bar, int d0,
                                         int t0, int h, int b) {
  tt::tma_load_4d(dst, map, bar, d0, coord(perm, 1, t0, h, b),
                  coord(perm, 2, t0, h, b), coord(perm, 3, t0, h, b));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the generic body's scalar arguments
struct Args {
  int Tq, Tkv;
  const float* bias;  // kVecBias: (H, Tq + Tkv - 1) or null (zeros);
                      // kFullBias: (H, Tq, bias_ld)
  long long bias_ld;  // kFullBias: floats a bias row (a multiple of 4)
  const float* mask;  // (B, Tkv) additive or null
  float scale;
};

template <typename OutT>
struct Out {
  OutT* p;
  long long s[3];  // element strides of (b, h, t)
};

template <int D, bool kCausal, int kBias, typename OutT>
__global__ void __launch_bounds__(kThreads,
                                  kBias == kFullBias ? 1 : Geo<D>::kMinBlocks)
attn_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, int qperm, int kperm,
            int vperm, const Args a, const Out<OutT> out) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tt::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = smem + G::kOffK;
  uint8_t* vs = smem + G::kOffV;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int Tq = a.Tq, Tkv = a.Tkv;
  const int tkpad = (Tkv + kBK - 1) / kBK * kBK;
  const int win = tkpad + kBQ + 2;  // bias window: deltas of this block
  float* bs0 = reinterpret_cast<float*>(smem + G::kOffF32);
  float* bs1 = bs0 + win;  // one delta ahead: bs1[x] = bs0[x + 1]
  float* ms = kBias == kVecBias ? bs1 + win : bs0;  // tkpad

  // a materialized bias orders the grid (q tile, b, h): the blocks of
  // one head run together for every batch row and share its bias in L2
  const int qt = blockIdx.x;
  const int h = kBias == kFullBias ? blockIdx.z : blockIdx.y;
  const int b = kBias == kFullBias ? blockIdx.y : blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = qt * kBQ;
  const int kend = kCausal ? min(Tkv, i0 + kBQ) : Tkv;
  const int ntiles = (kend + kBK - 1) / kBK;

  if (tid == kConsumers) {  // the maps' descriptors, while the block stages
    const CUtensorMap* maps[3] = {&qmap, &kmap, &vmap};
    for (int x = 0; x < 3; ++x)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(maps[x]))
                   : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tt::mbar_init(&full[s], 1);
      tt::mbar_init(&empty[s], kConsumers / 32);
    }
    tt::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kBias == kVecBias) {
    // the bias of delta = j - i sits at bs0[delta + i0 + kBQ - 1], times
    // log2 e; deltas past the vector's ends (keys past Tkv) clamp
    const float* bias_h =
        a.bias ? a.bias + (size_t)h * (Tq + Tkv - 1) + (Tq - 1) : nullptr;
    for (int x = tid; x < win + 1; x += kThreads) {
      const int dlt = min(max(x - (i0 + kBQ - 1), 1 - Tq), Tkv - 1);
      const float v = bias_h ? __ldg(bias_h + dlt) * kLog2e : 0.f;
      if (x < win) bs0[x] = v;
      if (x > 0) bs1[x - 1] = v;
    }
  }
  const float* mask_b = a.mask ? a.mask + (size_t)b * Tkv : nullptr;
  for (int j = tid; j < tkpad; j += kThreads)
    ms[j] = j < Tkv ? (mask_b ? __ldg(mask_b + j) * kLog2e : 0.f) : -INFINITY;
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane keeps the ring full
    if (tid == kConsumers) {
      const int nq = i0 + kBQ / 2 < Tq ? 2 : 1;  // Q boxes holding rows < Tq
      tt::mbar_expect_tx(qbar, nq * G::kTileBytes);
      for (int w = 0; w < nq; ++w)
        for (int nb = 0; nb < G::kNB; ++nb)
          load_box(qs + w * G::kTileBytes + nb * G::kBoxBytes, &qmap, qperm,
                   qbar, nb * G::kBW, i0 + w * kBQ / 2, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages, n = t / kStages;
        if (n > 0) tt::mbar_wait(&empty[st], (n - 1) & 1);
        tt::mbar_expect_tx(&full[st], 2 * G::kTileBytes);
        for (int nb = 0; nb < G::kNB; ++nb) {
          load_box(ks + st * G::kTileBytes + nb * G::kBoxBytes, &kmap, kperm,
                   &full[st], nb * G::kBW, t * kBK, h, b);
          load_box(vs + st * G::kTileBytes + nb * G::kBoxBytes, &vmap, vperm,
                   &full[st], nb * G::kBW, t * kBK, h, b);
        }
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
  const uint8_t* qtile = qs + wg * G::kTileBytes;
  // window index of (key 2tg of tile 0, row r0); its parity picks the copy
  // that makes the pair 8-byte aligned
  const int xb = 2 * tg - r0 + i0 + kBQ - 1;
  const float* bp = (xb & 1) ? bs1 + xb - 1 : bs0 + xb;
  const float* mp = ms + 2 * tg;
  const float sl2 = a.scale * kLog2e;

  float o[G::kNB][G::kBW / 2];
#pragma unroll
  for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < G::kBW / 2; ++i) o[nb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32], corr[2];
  uint32_t pa[4][4];
  // kFullBias: this tile's bias pairs and (below width 128, where the
  // registers allow) the next tile's, in flight
  constexpr bool kAhead = kBias == kFullBias && D < 128;
  float2 bf[8][2], bn[8][2];
  const float* brow =
      kBias == kFullBias ? a.bias + ((size_t)h * Tq + r0) * a.bias_ld + 2 * tg
                         : nullptr;
  const bool row0 = r0 < Tq, row1 = r0 + 8 < Tq;
  if (kAhead && ntiles > 0)
    load_bias(bf, brow, a.bias_ld, row0, row1, 2 * tg, Tkv);

  tt::mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages, j0 = t * kBK;
    if (kAhead && t + 1 < ntiles)
      load_bias(bn, brow + j0 + kBK, a.bias_ld, row0, row1,
                j0 + kBK + 2 * tg, Tkv);
    else if (kBias == kFullBias && !kAhead)
      load_bias(bf, brow + j0, a.bias_ld, row0, row1, j0 + 2 * tg, Tkv);
    tt::mbar_wait(&full[st], (t / kStages) & 1);
    if (!kCausal || j0 <= wg_last) {
      tt::wgmma_fence();
      issue_qk<D>(s, qtile, ks + st * G::kTileBytes);
      tt::wgmma_wait<0>();
      tt::fence_regs(s);
      softmax_tile<kCausal, kBias>(s, bp, bf, mp, j0, r0, tg, sl2, m, l,
                                   corr);
      rescale<D>(o, corr);
      pack_p(s, pa);
      fence_out<D>(o);
      tt::wgmma_fence();
      issue_pv<D>(o, pa, vs + st * G::kTileBytes);
      tt::wgmma_wait<0>();
      fence_out<D>(o);
    }
    __syncwarp();
    if (lane == 0) tt::mbar_arrive(&empty[st]);
    if (kAhead) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bf[c][0] = bn[c][0];
        bf[c][1] = bn[c][1];
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int i = r0 + hf * 8;
    if (i < Tq) {
      const float inv = 1.f / fmaxf(l[hf], 1e-30f);
      OutT* orow = out.p + b * out.s[0] + h * out.s[1] + i * out.s[2];
#pragma unroll
      for (int nb = 0; nb < G::kNB; ++nb)
#pragma unroll
        for (int j = 0; j < G::kBW / 8; ++j)
          store_pair(orow + nb * 64 + j * 8 + tg * 2,
                     o[nb][4 * j + 2 * hf] * inv,
                     o[nb][4 * j + 2 * hf + 1] * inv);
    }
  }
}

// dynamic shared memory of the generic body: the 1024-byte alignment
// slack, Q, the K/V ring, the barriers, the mask (Tkv padded to a tile)
// and, with a Toeplitz bias, its two windows. ops/cuda/flash_attention.py
// (tma_smem_bytes) computes the same to name the limit.
template <int D>
size_t smem_bytes(int Tkv, int mode) {
  const size_t tkpad = (Tkv + kBK - 1) / kBK * kBK;
  const size_t window = mode == kVecBias ? 2 * (tkpad + kBQ + 2) : 0;
  return 1024 + Geo<D>::kOffF32 + sizeof(float) * (window + tkpad);
}

// An operand's tensor map: dims[4] (d first, then t, h, b in the order of
// their strides), byte strides[3] of dims 1..3, and perm, the map slot
// (1..3) of t, h and b in bits 0-1, 2-3, 4-5. The box is min(D, 64)
// columns by 64 rows of t, in the swizzle of its row width.
bool encode(CUtensorMap* map, const void* p, const long long* dims,
            const long long* strides, int perm, int D) {
  tt::EncodeTiled enc = tt::encode_tiled();
  if (!enc || reinterpret_cast<uintptr_t>(p) % 16 || dims[0] != D) return false;
  const int bw = D < 64 ? D : 64;
  cuuint64_t gd[4];
  cuuint64_t gs[3];
  cuuint32_t box[4] = {(cuuint32_t)bw, 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  for (int x = 0; x < 4; ++x) {
    if (dims[x] < 1 || dims[x] > (1ll << 31)) return false;
    gd[x] = (cuuint64_t)dims[x];
  }
  for (int x = 0; x < 3; ++x) {
    if (strides[x] <= 0 || strides[x] % 16 || strides[x] >= (1ll << 40))
      return false;
    gs[x] = (cuuint64_t)strides[x];
  }
  const int slot_t = perm & 3;
  if (slot_t < 1 || slot_t > 3) return false;
  box[slot_t] = kBK;
  const CUtensorMapSwizzle swizzle = bw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : bw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             gd, gs, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The last kSlots encoded maps. A call encodes three maps on the host;
// the model passes views of the same allocations step after step, and a
// map depends on nothing but encode()'s arguments, so a hit is exact.
class MapCache {
 public:
  bool get(CUtensorMap* map, const void* p, const long long* dims,
           const long long* strides, int perm, int D) {
    Key key{p, {dims[0], dims[1], dims[2], dims[3]},
            {strides[0], strides[1], strides[2]}, perm, D};
    std::lock_guard<std::mutex> lock(mu_);
    for (int i = 0; i < used_; ++i)
      if (keys_[i] == key) {
        *map = maps_[i];
        return true;
      }
    if (!encode(map, p, dims, strides, perm, D)) return false;
    keys_[next_] = key;
    maps_[next_] = *map;
    next_ = (next_ + 1) % kSlots;
    if (used_ < kSlots) ++used_;
    return true;
  }

 private:
  static constexpr int kSlots = 64;
  struct Key {
    const void* p;
    long long dims[4], strides[3];
    int perm, D;
    bool operator==(const Key& o) const {
      for (int x = 0; x < 4; ++x)
        if (dims[x] != o.dims[x] || (x < 3 && strides[x] != o.strides[x]))
          return false;
      return p == o.p && perm == o.perm && D == o.D;
    }
  };
  std::mutex mu_;
  Key keys_[kSlots];
  CUtensorMap maps_[kSlots];
  int used_ = 0, next_ = 0;
};
MapCache map_cache;

struct Maps {
  CUtensorMap m[3];
  int perm[3];
};

template <int D, bool kCausal, int kBias, typename OutT>
int launch_body(const Maps& maps, int B, int H, const Args& a,
                const Out<OutT>& out, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(a.Tkv, kBias);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto* fn = attn_kernel<D, kCausal, kBias, OutT>;
  static tt::KernelFacts facts;
  const cudaError_t err = facts.allow_smem(reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return (int)err;
  const int nq = (a.Tq + kBQ - 1) / kBQ;
  const dim3 grid = kBias == kFullBias ? dim3(nq, B, H) : dim3(nq, H, B);
  fn<<<grid, kThreads, smem, stream>>>(maps.m[0], maps.m[1], maps.m[2],
                                       maps.perm[0], maps.perm[1],
                                       maps.perm[2], a, out);
  return (int)cudaGetLastError();
}

// The instantiations: bf16 output for B and D1 (non-causal, a Toeplitz
// bias or none) and C (causal, no bias); f32 output (D2) for every
// causal flag and bias mode.
template <int D>
int launch(const Maps& maps, int B, int H, const Args& a, int causal,
           int mode, void* out, const long long* ostr, int out_f32,
           cudaStream_t stream) {
  if (!out_f32) {
    const Out<__nv_bfloat16> o{static_cast<__nv_bfloat16*>(out),
                               {ostr[0], ostr[1], ostr[2]}};
    if (!causal && mode == kVecBias)
      return launch_body<D, false, kVecBias>(maps, B, H, a, o, stream);
    if (causal && mode == kNoBias)
      return launch_body<D, true, kNoBias>(maps, B, H, a, o, stream);
    return (int)cudaErrorInvalidValue;
  }
  const Out<float> o{static_cast<float*>(out), {ostr[0], ostr[1], ostr[2]}};
  if (!causal)
    return mode == kFullBias
               ? launch_body<D, false, kFullBias>(maps, B, H, a, o, stream)
               : launch_body<D, false, kVecBias>(maps, B, H, a, o, stream);
  switch (mode) {
    case kNoBias: return launch_body<D, true, kNoBias>(maps, B, H, a, o, stream);
    case kVecBias: return launch_body<D, true, kVecBias>(maps, B, H, a, o, stream);
    default: return launch_body<D, true, kFullBias>(maps, B, H, a, o, stream);
  }
}

// The fused-qkv body of B and C at head width 64: one 3-D map (channels,
// T, B) over the whole qkv, a K or V tile the box at the part's channel
// offset; the bias window is staged once and read a score at a time, the
// scores times log2 e after the sum. It is the generic body's design at
// D = 64; on an H100 it runs B and C 3-10% faster than attn_kernel<64>
// (PERF.md), so they keep it at that width.
constexpr int kD = 64;
constexpr int kTile = kBK * kD;    // bf16 elements of one 64 x 64 tile
constexpr unsigned kTileBytes = kTile * 2;
constexpr int kOffQ = 0;                           // 2 x 64 query rows
constexpr int kOffK = kOffQ + 2 * kTile * 2;       // kStages K tiles
constexpr int kOffV = kOffK + kStages * kTile * 2; // kStages V tiles
constexpr int kOffBar = kOffV + kStages * kTile * 2;
constexpr int kOffF32 = kOffBar + 128;             // bias window, mask

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
qkv_kernel(const __grid_constant__ CUtensorMap qkv_map, int T, int H,
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
  const uint64_t dq = smem_desc<kD>(qs + wg * kTile);

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
      const uint64_t dk = smem_desc<kD>(ks + st * kTile);
      tt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // over the head width, 16 at a time
        wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
      tt::wgmma_commit();
      tt::wgmma_wait<0>();
      tt::fence_regs(s);

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
      const uint64_t dv = smem_desc<kD>(vs + st * kTile);
      tt::fence_regs(o);
      tt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // over the tile's keys, 16 at a time
        wgmma_rs(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
      tt::wgmma_commit();
      tt::wgmma_wait<0>();
      tt::fence_regs(o);
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

size_t qkv_smem_bytes(int T) {
  const int tpad = (T + kBK - 1) / kBK * kBK;
  return 1024 + kOffF32 + sizeof(float) * (2 * tpad + kBQ);
}

template <bool kCausal>
int launch_qkv(const void* qkv, int B, int T, int H, int D, int q_off,
               int k_off, int v_off, int head_stride, const float* bias,
               const float* mask, float scale, void* out,
               cudaStream_t stream) {
  const size_t smem = qkv_smem_bytes(T);
  if (D != kD || B < 1 || T < 1 || H < 1 || smem > kSmemLimit ||
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
  static tt::KernelFacts facts;
  const cudaError_t err = facts.allow_smem(
      reinterpret_cast<const void*>(qkv_kernel<kCausal>));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  qkv_kernel<kCausal><<<grid, kThreads, smem, stream>>>(
      map, T, H, q_off, k_off, v_off, head_stride, bias, mask, scale,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels B, C, D1 and D2 (bf16) on the generic body. q (B, H, Tq, D),
// k and v (B, H, Tkv, D): bf16 views, d contiguous, each 16-byte aligned;
// geom[24] = for q, k, v in turn: dims[4] (D, then t, h, b in their map
// order), byte strides[3] of map dims 1..3, and perm (the map slots of t,
// h, b, 2 bits each); ostr[3] = element strides of (b, h, t) of the
// output (d contiguous): bf16 (out_f32 = 0; B, C, D1) or f32 (D2). At
// most one bias: bias_vec (H, Tq + Tkv - 1) f32 Toeplitz vector, or
// bias_full (H, Tq, bias_ld) f32 materialized, bias_ld >= Tkv a multiple
// of 4, 16-byte aligned; mask (B, Tkv) f32 additive or null; causal: key
// j is seen by row i when j <= i.
TT_EXPORT int tt_flash_tma(const void* q, const void* k, const void* v,
                           void* out, const long long* geom,
                           const long long* ostr, int B, int H, int Tq,
                           int Tkv, int D, const float* bias_vec,
                           const float* bias_full, long long bias_ld,
                           const float* mask, float scale, int causal,
                           int out_f32, cudaStream_t stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || B > 65535 || H > 65535 ||
      (bias_vec && bias_full) ||
      reinterpret_cast<uintptr_t>(out) % (out_f32 ? 8 : 4) || ostr[0] % 2 ||
      ostr[1] % 2 || ostr[2] % 2)
    return (int)cudaErrorInvalidValue;
  if (bias_full && (bias_ld < Tkv || bias_ld % 4 ||
                    reinterpret_cast<uintptr_t>(bias_full) % 16))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  Maps maps;
  for (int x = 0; x < 3; ++x) {
    const long long* gx = geom + 8 * x;
    maps.perm[x] = (int)gx[7];
    if (!map_cache.get(&maps.m[x], ptrs[x], gx, gx + 4, maps.perm[x], D))
      return (int)cudaErrorInvalidValue;
  }
  const int mode = bias_full ? kFullBias
                   : bias_vec || !causal ? kVecBias
                                         : kNoBias;
  const Args a{Tq, Tkv, bias_full ? bias_full : bias_vec, bias_ld, mask,
               scale};
  switch (D) {
    case 16: return launch<16>(maps, B, H, a, causal, mode, out, ostr,
                               out_f32, stream);
    case 32: return launch<32>(maps, B, H, a, causal, mode, out, ostr,
                               out_f32, stream);
    case 64: return launch<64>(maps, B, H, a, causal, mode, out, ostr,
                               out_f32, stream);
    case 128: return launch<128>(maps, B, H, a, causal, mode, out, ostr,
                                 out_f32, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel B. qkv (B, T, 3*H*D) bf16 interleaved per head, 16-byte aligned;
// bias (H, 2T-1) f32 or null; mask (B, T) f32 additive or null; out
// (B, T, H*D) bf16. Channel offsets: q, k, v of head 0 at 0, D, 2D; head
// h adds h * 3D.
TT_EXPORT int tt_flash_packed(const void* qkv, int B, int T, int H, int D,
                              const float* bias, const float* mask,
                              float scale, void* out, cudaStream_t stream) {
  return launch_qkv<false>(qkv, B, T, H, D, 0, kD, 2 * kD, 3 * kD, bias, mask,
                       scale, out, stream);
}

// Kernel C. qkv (B, S, 3*H*D) bf16 part-major, 16-byte aligned; mask
// (B, S) f32 additive or null; out (B, S, H*D) bf16. Channel offsets: q,
// k, v of head 0 at 0, H*D, 2*H*D; head h adds h * D.
TT_EXPORT int tt_flash_causal_qkv(const void* qkv, int B, int S, int H, int D,
                                  const float* mask, float scale, void* out,
                                  cudaStream_t stream) {
  return launch_qkv<true>(qkv, B, S, H, D, 0, H * kD, 2 * H * kD, kD, nullptr,
                      mask, scale, out, stream);
}
