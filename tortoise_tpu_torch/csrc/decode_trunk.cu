// AR decode trunk for one token step (kernel A): one persistent launch.
//
// Replaces tortoise_tpu/ops/pallas/decode_trunk.py::fused_decode_trunk
// (the Pallas kernel runs all layers as one sequential (L, B) grid that
// carries the activation in VMEM).
//
// What bounds it on the card: streaming the int8 weights (12.6 MB a layer
// at d=1024, 377 MB for 30 layers), the lm head (8.5 MB) and the bf16 KV
// cache once per step, about 0.14 ms at B = 1 and C = 640. A step is a
// chain of 212 dependent phases, so what the card loses is each phase's
// grid barrier (~1.4 us) and its chain of L2 round trips, not bandwidth;
// and one block reads its cache tiles far below its share of the card's
// bandwidth, so a phase spreads its bytes over the SMs.
//
// Design: tt_decode_trunk issues ONE cooperative launch of
// decode_step_kernel with as many blocks as the card holds at once (the
// occupancy API's count, so every block is resident and the grid barrier
// cannot deadlock). The blocks walk all layers together, separated by a
// grid barrier (a generation counter) between phases:
//
//   R0   rows:   LN1 of layer 0 over x                   -> y (bf16)
//   per layer l:
//   QKV  items:  int8 qkv matvec                         -> partial sums A
//   ATT  (b, h, chunk): sum A; cache softmax with the fresh column ->
//                context sums, K/V rows
//   PROJ items:  the chunks combined as the operand; int8 proj matvec ->
//                partial sums B; a column tile's last item adds the
//                residual into x
//   R2   rows:   LN2                                     -> y
//   FC   items:  int8 fc matvec -> partial sums A; a tile's last item
//                writes GELU -> hdn (bf16)
//   FP   items:  int8 fc_proj matvec -> partial sums B; a tile's last item
//                adds the residual into x
//   R1   rows:   LN1 of l+1 (or the head's double LN)    -> y
//   then optionally HEAD items (int8 lm head; a tile's last item writes
//   the logits) and, per row, the sampler.
//
// Each LayerNorm runs once, in the row phase after its residual (one block
// per row), never per matvec block. A matvec item is 128 output
// columns by K / ks input rows, the split ks chosen on the host so one
// phase's items fill the grid once. Its int8 weight tile arrives by TMA as
// four boxes of 128-byte rows in the 128-byte swizzle, each on its own
// mbarrier; weights depend on nothing the step computes, so a block issues
// the tile of its NEXT matvec item as soon as it finishes the current one,
// and the load runs under the barriers and the attention or row phase in
// between. After the barrier only the bf16 operand rows (bulk copies) are
// on the critical path. Each warp owns 8 of the 128 columns and runs
// mma.sync m16n8k16 over all the item's rows: the batch rows (zero-padded
// to 8 or 16) are the A operand, the weights, exact in bf16, the B
// operand. Every item writes its raw sums to a partial buffer; the phase
// that reads them adds the ks partials in a fixed order, and for fc and
// the head the last of a column tile's ks items to finish (a counter per
// tile) does it at once, writing GELU(fc) as bf16 and the logits as f32.
// So the step repeats bit for bit.
//
// The cache attention of one (row, head) is split over as many blocks as
// the B * H groups leave idle (5 at B = 1 and C = 640, none at B = 16),
// B being split_b when the caller names a larger batch (a dp rank's rows
// split as the whole batch's, so a row's bits do not depend on the dp
// size: the chunks' sums meet in another order when the split differs):
// a block's K and V tiles of 64 slots stream through an 8-stage TMA ring,
// its first tiles issued before the barrier, like the weights. The
// chunks of a group meet once, at a counter barrier over their score
// maxima, so every softmax weight is exp(s - the row's max) as in one
// pass; each chunk writes its context sums and normaliser, and the proj
// phase adds them as it stages its operand.
//
// Every block also warms its share of the next layer's KV cache (when it
// fits), fc_proj weights and vectors into the 50 MB L2 (prefetch.global.L2)
// during the attention phase. Data written by other blocks is read through
// L2 only (bulk copies, ld.cg); the grid barrier and the counters are
// gpu-scope release/acquire atomics.
//
// The sampler keeps the top-k exact without k passes over the
// vocabulary: each warp's r-th largest lane maximum (r = ceil(k / 16))
// bounds the k-th largest value from below, so the values at or above the
// least of these bounds (about k of them) hold the whole top-k; they are
// ranked by (value, then first index), and one warp runs the nucleus drop
// and the inverse CDF.
//
// Numerics are the Pallas kernel's: activations stay f32, matvec operands
// are rounded to bf16 and the int8 weights are exact in bf16, so every
// product is exact in f32 and only the summation order differs; the
// sampler breaks ties toward the first index and never drops the top
// candidate.
#include "common.cuh"

namespace {

constexpr int kMaxB = 16;      // rows per step (FUSED_MAX_BATCH)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 64;        // head width
constexpr int kMaxC = 4096;    // cache slots
constexpr int kMaxVp = 10240;  // padded vocab
constexpr int kSortCap = 16384;  // a power of two >= kMaxVp
constexpr int kMaxTopK = 128;
constexpr int kTileN = 128;    // matvec item width: 16 warps x 8 columns
constexpr int kMinRows = 64;   // matvec item depth: a multiple of 64 ...
constexpr int kMaxRows = 512;  // ... up to 512 input rows
constexpr int kMaxSplit = 16;  // partial sums a column may have
constexpr int kAttRows = 64;   // cache slots per attention tile
constexpr int kAttStages = 8;  // attention tiles in flight

enum { ROW_LN = 0, ROW_HEAD = 1 };
enum { FIN_NONE = 0, FIN_LOGITS, FIN_GELU, FIN_RESID };

enum { MAP_ATTN = 0, MAP_PROJ, MAP_FC, MAP_FP, MAP_LM, kMaps };

struct Params {
  // TMA maps of the int8 weights as (out, in, layer) boxes of 128 columns
  // by a quarter of an item's rows, and each matvec's split of its rows
  CUtensorMap wmap[kMaps];
  int ks[kMaps];
  // TMA maps of the cache K and V as (D, C, L * B) boxes of one head's 64
  // dims by kAttRows slots
  CUtensorMap kmap, vmap;
  // the cache attention of one (row, head) runs as nchunk items of ct
  // tiles of kAttRows slots each
  int nchunk, ct;
  int L, B, C, D, H, F, Vp;
  float eps;
  float* x;  // (B, D) f32, updated in place into the final hidden state
  const float* bias_row;
  const float *ln1_w, *ln1_b;
  const int8_t* attn_w;
  const float *attn_s, *attn_b;
  const int8_t* proj_w;
  const float *proj_s, *proj_b;
  const float *ln2_w, *ln2_b;
  const int8_t* fc_w;
  const float *fc_s, *fc_b;
  const int8_t* fp_w;
  const float *fp_s, *fp_b;
  const __nv_bfloat16 *cache_k, *cache_v;
  __nv_bfloat16 *k_rows, *v_rows;
  // lm head (lm_wq == nullptr: no head)
  const float *lnf_w, *lnf_b, *lmln_w, *lmln_b;
  const int8_t* lm_wq;
  const float *lm_sc, *lm_b;
  float* logits;
  // sampler (tok == nullptr: no sampler)
  const int* prev;
  const float* u;
  float inv_temp, top_p_drop, penalty;
  int top_k;
  int* tok;
  // scratch
  __nv_bfloat16* y;       // (B, D) LN output, the next matvec's operand
  float* att_part;        // per attention item: 64 context sums, the
                          // normaliser, the item's score max
  __nv_bfloat16* hdn;     // (B, F) GELU output, fc_proj's operand
  unsigned* tile_count;   // finished items of each matvec column tile
  unsigned* att_count;    // arrived items of each (row, head) group
  float* part_a;          // (ks, B, N) partial sums of qkv, fc and the head
  float* part_b;          // (ks, B, D) partial sums of proj and fc_proj
  unsigned* bar;          // grid barrier: arrival count, generation
  unsigned long long* trace;  // null, or the times of every barrier
};

constexpr int kTraceWork = 2048;  // trace slots of the work-end times

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Every block warms its share of [p, p + bytes) into L2, one 128-byte
// line per thread at a time.
__device__ void prefetch_l2(const void* p, size_t bytes) {
  const size_t lines = (bytes + 127) / 128;
  const size_t per = (lines + gridDim.x - 1) / gridDim.x;
  const size_t stop = (blockIdx.x + 1ull) * per;
  const size_t end = stop < lines ? stop : lines;
  for (size_t i = blockIdx.x * per + threadIdx.x; i < end; i += kThreads)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(static_cast<const char*>(p) +
                                                     i * 128));
}

// gpu-scope release / acquire accesses: a block's writes, ordered before
// its thread 0 by __syncthreads, are released by that thread's atomic and
// acquired by whoever reads the atomic's result or a later release.
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Grid-wide barrier over co-resident blocks: the last block to arrive
// resets the count and publishes the next generation, which the others
// wait for. gen is the generation this block last saw (read once at the
// start of the step); k counts this block's barriers (every block passes
// the same sequence).
__device__ void grid_sync(const Params& P, int& k, unsigned& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    if (P.trace) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      atomicMax(P.trace + kTraceWork + k, t);  // the last block's arrival
    }
    if (atom_add_acq_rel(P.bar, 1u) == gridDim.x - 1) {
      *reinterpret_cast<volatile unsigned*>(P.bar) = 0u;
      st_release(P.bar + 1, gen + 1);
    } else {
      while (ld_acquire(P.bar + 1) == gen) {
      }
    }
    if (P.trace && blockIdx.x == 0) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      P.trace[1 + k] = t;
    }
  }
  ++k;
  ++gen;
  __syncthreads();
}

// Sum of the ks partials of (b, n) in a (ks, B, N) buffer, in split
// order; the loads are all issued before the first add.
__device__ __forceinline__ float part_sum(const float* part, int ks, int B,
                                          int N, int b, int n) {
  float v[kMaxSplit];
#pragma unroll
  for (int j = 0; j < kMaxSplit; ++j)
    v[j] = j < ks ? __ldcg(part + ((size_t)j * B + b) * N + n) : 0.f;
  float s = v[0];
#pragma unroll
  for (int j = 1; j < kMaxSplit; ++j) s += v[j];
  return s;
}

// Columns a thread holds in a row phase: column tid + j * kThreads is
// v[j] (D <= 2048).
constexpr int kRowCols = 4;

// LN (two-pass mean/variance, like the JAX layer_norm, without affine) of
// the block's length-n row held in registers.
__device__ void ln_regs(float (&v)[kRowCols], int n, float eps, float* red) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kRowCols; ++j)
    if (threadIdx.x + j * kThreads < n) s += v[j];
  const float mean = tt::block_sum(s, red) / (float)n;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) {
    if (threadIdx.x + j * kThreads < n) {
      const float d = v[j] - mean;
      q += d * d;
    }
  }
  const float inv = rsqrtf(tt::block_sum(q, red) / (float)n + eps);
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) v[j] = (v[j] - mean) * inv;
}

// Row phase of row b (one block): the LN chain of `mode` over x[b] into
// y[b] as bf16: ROW_LN with the affine (w1, b1); ROW_HEAD the head's
// LN(ln_f) -> bare LN -> lm_ln affine. Every load is issued before the
// first sum.
__device__ void row_phase(const Params& P, int b, int mode, const float* w1,
                          const float* b1, float* red) {
  const int D = P.D;
  const bool hd = mode == ROW_HEAD;
  const float* ga = hd ? P.lnf_w : w1;
  const float* gb = hd ? P.lnf_b : b1;
  float v[kRowCols], wa[kRowCols], ba[kRowCols], wz[kRowCols], bz[kRowCols];
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) {
    const int n = threadIdx.x + j * kThreads;
    const bool ok = n < D;
    v[j] = ok ? __ldcg(P.x + (size_t)b * D + n) : 0.f;
    wa[j] = ok ? ga[n] : 0.f;
    ba[j] = ok ? gb[n] : 0.f;
    wz[j] = ok && hd ? P.lmln_w[n] : 0.f;
    bz[j] = ok && hd ? P.lmln_b[n] : 0.f;
  }
  ln_regs(v, D, P.eps, red);
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) v[j] = v[j] * wa[j] + ba[j];
  if (hd) {
    ln_regs(v, D, P.eps, red);
#pragma unroll
    for (int j = 0; j < kRowCols; ++j) v[j] = v[j] * wz[j] + bz[j];
  }
#pragma unroll
  for (int j = 0; j < kRowCols; ++j) {
    const int n = threadIdx.x + j * kThreads;
    if (n < D) P.y[(size_t)b * D + n] = __float2bfloat16(v[j]);
  }
}

// Weight byte (r, c) of a tile of 128-byte rows in the TMA's 128-byte
// swizzle: 16-byte chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ float wbyte(const int8_t* ws, int r, int c) {
  return static_cast<float>(ws[r * kTileN + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))]);
}

// Matvec items of one phase: 128 columns x (K / ks) input rows each.
struct Matvec {
  int map, layer, K, N;
  __device__ int items(const Params& P) const { return N / kTileN * P.ks[map]; }
};

// Starts the TMA of the int8 weight tile of `item` into ws as four boxes
// of a quarter of its rows, each on its own mbarrier. Weights depend on
// nothing the step computes, so a block issues its next phase's tile as
// soon as ws is free, ahead of the grid barriers in between.
__device__ void issue_weights(const Params& P, const Matvec& m, int item,
                              uint8_t* ws, uint64_t* mbw) {
  if (threadIdx.x != 0 || item >= m.items(P)) return;
  const int tiles = m.N / kTileN, kc = m.K / P.ks[m.map], quarter = kc / 4;
  const int n0 = (item % tiles) * kTileN, k0 = (item / tiles) * kc;
  for (int q = 0; q < 4; ++q) {
    tt::mbar_expect_tx(&mbw[q], quarter * kTileN);
    tt::tma_load_3d(ws + q * quarter * kTileN, &P.wmap[m.map], &mbw[q], n0,
                    k0 + q * quarter, m.layer);
  }
}

// The last of a column tile's ks items to finish (a counter per tile)
// adds the tile's partials in split order and finishes its 128 columns
// of v = sum * gs + gb: FIN_LOGITS stores v, FIN_GELU stores GELU(v) as
// bf16 into hdn, FIN_RESID adds v to x.
__device__ void finish_tile(const Params& P, const float* part, int ks,
                            int N, int tile, const float* gs, const float* gb,
                            int fin, int* flag) {
  __syncthreads();  // every partial of this item is stored
  if (threadIdx.x == 0) {
    const unsigned done = atom_add_acq_rel(P.tile_count + tile, 1u);
    *flag = done == (unsigned)ks - 1;
    if (*flag) P.tile_count[tile] = 0u;  // ready for the next layer
  }
  __syncthreads();
  if (!*flag) return;
  for (int i = threadIdx.x; i < P.B * kTileN; i += kThreads) {
    const int b = i / kTileN, n = tile * kTileN + i % kTileN;
    const float v = part_sum(part, ks, P.B, N, b, n) * gs[n] + gb[n];
    const size_t o = (size_t)b * N + n;
    if (fin == FIN_LOGITS) P.logits[o] = v;
    else if (fin == FIN_GELU) P.hdn[o] = __float2bfloat16(gelu_tanh(v));
    else P.x[o] = __ldcg(P.x + o) + v;
  }
}

// part[kz, b, n] = sum over the item's rows k of in[b, k] * w[k, n] for
// the rows of P.B, the operand rows copied from `in` (bf16, row stride
// K) or, with in == nullptr, combined from the attention items' context
// sums (att_part). With fin != FIN_NONE the phase also finishes each
// column tile (finish_tile). The block's first item's weights
// were issued before the phase; on leaving, it issues its first item of
// `next`.
__device__ void matvec_phase(const Params& P, const Matvec& m,
                             const __nv_bfloat16* in, float* part,
                             const Matvec* next, uint8_t* ws,
                             __nv_bfloat16* ys, uint64_t* mbw, uint64_t* mby,
                             unsigned& wl, unsigned& yl, int* flag,
                             int fin = FIN_NONE, const float* gs = nullptr,
                             const float* gb = nullptr) {
  const int B = P.B, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, K = m.K, N = m.N;
  const int ks = P.ks[m.map], kc = K / ks, quarter = kc / 4, yst = kc + 8;
  const int tiles = N / kTileN, rows = B > 8 ? 16 : 8;
  // the A operand's padding rows B.. stay zero through the phase
  uint32_t* pad = reinterpret_cast<uint32_t*>(ys + B * yst);
  for (int i = tid; i < (rows - B) * yst / 2; i += kThreads) pad[i] = 0u;
  for (int item = blockIdx.x; item < tiles * ks; item += gridDim.x) {
    const int n0 = (item % tiles) * kTileN, kz = item / tiles, k0 = kz * kc;
    __syncthreads();  // ws and ys of the previous item are free
    if (item != blockIdx.x) issue_weights(P, m, item, ws, mbw);
    if (in && tid == 0) {
      // the operand rows, one bulk copy per batch row; other blocks wrote
      // them with generic stores
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      tt::mbar_expect_tx(mby, kc * 2 * B);
      for (int b = 0; b < B; ++b)
        tt::bulk_load(ys + b * yst, in + (size_t)b * K + k0, kc * 2, mby);
    }
    if (!in) {  // the attention context: its chunks' sums over their normaliser
      const int nc = P.nchunk;
      for (int i = tid; i < B * kc; i += kThreads) {
        const int b = i / kc, k = k0 + i % kc;
        const float* pa = P.att_part +
                          ((size_t)(b * P.H + k / kDh) * nc) * (kDh + 2);
        float ctx = 0.f, den = 0.f;
        for (int c = 0; c < nc; ++c) {
          ctx += __ldcg(pa + c * (kDh + 2) + k % kDh);
          den += __ldcg(pa + c * (kDh + 2) + kDh);
        }
        ys[b * yst + i % kc] = __float2bfloat16(ctx / den);
      }
    }
    __syncthreads();  // the padding and the context rows are in place
    if (in) tt::mbar_wait(mby, yl++ & 1);
    // two accumulators over alternate 16-row steps, added at the end
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int col = warp * 8 + g;  // this lane's B-operand column
    const int8_t* w8 = reinterpret_cast<const int8_t*>(ws);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tt::mbar_wait(&mbw[q], wl & 1);
      for (int k0s = q * quarter; k0s < (q + 1) * quarter; k0s += 32) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0s + 16 * h;
          if (k >= (q + 1) * quarter) break;
          const __nv_bfloat16* y0 = ys + g * yst + k + 2 * tg;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(y0);
          a[2] = *reinterpret_cast<const uint32_t*>(y0 + 8);
          a[1] = B > 8 ? *reinterpret_cast<const uint32_t*>(y0 + 8 * yst) : 0u;
          a[3] = B > 8 ? *reinterpret_cast<const uint32_t*>(y0 + 8 * yst + 8) : 0u;
          const int r = k + 2 * tg;
          tt::mma_bf16(acc[h], a,
                       tt::pack_bf16(wbyte(w8, r, col), wbyte(w8, r + 1, col)),
                       tt::pack_bf16(wbyte(w8, r + 8, col), wbyte(w8, r + 9, col)));
        }
      }
    }
    ++wl;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][i] += acc[1][i];
    // rows g and g + 8, columns 2 tg and 2 tg + 1 of this warp's 8
    const int n = n0 + warp * 8 + 2 * tg;
    if (g < B)
      *reinterpret_cast<float2*>(part + ((size_t)kz * B + g) * N + n) =
          make_float2(acc[0][0], acc[0][1]);
    if (g + 8 < B)
      *reinterpret_cast<float2*>(part + ((size_t)kz * B + g + 8) * N + n) =
          make_float2(acc[0][2], acc[0][3]);
    if (fin != FIN_NONE)
      finish_tile(P, part, ks, N, item % tiles, gs, gb, fin, flag);
  }
  __syncthreads();  // ws is free
  if (next) issue_weights(P, *next, blockIdx.x, ws, mbw);
}

// The attention phase's shared memory (after the matvec's weight tile
// and operand rows): a ring of cache tiles, the scores, the fresh q/k/v,
// and the reduction scratch the row phases use too.
struct AttSmem {
  __nv_bfloat16* ring;  // kAttStages x kAttRows x 64
  float *s, *qs, *qb, *kn, *vn, *red, *self_s, *ctxp;
  int* flag;  // a block-wide flag (finish_tile)
  __device__ explicit AttSmem(float* fs) {
    ring = reinterpret_cast<__nv_bfloat16*>(fs);
    s = fs + kAttStages * kAttRows * kDh / 2;  // kMaxC
    qs = s + kMaxC;                            // 64 each
    qb = qs + kDh;
    kn = qb + kDh;
    vn = kn + kDh;
    red = vn + kDh;                            // 32
    self_s = red + 32;                         // 1 (+ pad)
    flag = reinterpret_cast<int*>(self_s + 1);
    ctxp = self_s + 32;                        // (kThreads / 8) x 64
  }
};

// The cache tiles of one attention item: its K tiles of kAttRows slots,
// then its V tiles, through a ring of kAttStages stages. The block's n-th
// tile goes to stage n % kAttStages; `issued` and `done` count the tiles
// every thread has seen issued and consumed (thread 0 issues).
struct AttRing {
  unsigned issued = 0, done = 0;
};

// An attention item: chunk j of the slots of (row b, head h).
struct AttItem {
  int b, h, j, t0, tn;  // tiles t0 .. t0 + tn - 1 of kAttRows slots
  __device__ AttItem(const Params& P, int item) {
    const int bh = item / P.nchunk, nt = (P.C + kAttRows - 1) / kAttRows;
    b = bh / P.H;
    h = bh % P.H;
    j = item % P.nchunk;
    t0 = j * P.ct;
    tn = min(P.ct, nt - t0);
  }
};

__device__ void attn_issue(const Params& P, int l, const AttItem& it, int t,
                           AttRing& r, const AttSmem& a, uint64_t* mba) {
  if (threadIdx.x == 0) {
    const int st = r.issued % kAttStages;
    tt::mbar_expect_tx(&mba[st], kAttRows * kDh * 2);
    tt::tma_load_3d(a.ring + st * kAttRows * kDh, t < it.tn ? &P.kmap : &P.vmap,
                    &mba[st], it.h * kDh, (it.t0 + t % it.tn) * kAttRows,
                    l * P.B + it.b);
  }
  ++r.issued;
}

// Issues the first tiles of `item` (as many as the ring holds). The cache
// depends on nothing the step computes, so a block issues its first item
// before the barrier that precedes the attention phase.
__device__ void attn_prologue(const Params& P, int l, int item, AttRing& r,
                              const AttSmem& a, uint64_t* mba) {
  if (item >= P.B * P.H * P.nchunk) return;
  const AttItem it(P, item);
  for (int t = 0; t < 2 * it.tn && t < kAttStages; ++t)
    attn_issue(P, l, it, t, r, a, mba);
}

// One attention item, its first tiles already issued: chunk j of
// softmax(q.K / sqrt(Dh) + bias_row) over the cached keys with the fresh
// token's own key folded into the max and the denominator (chunk 0), and
// its share of the context over the cached values plus (chunk 0) the
// fresh value. The chunks of one (row, head) meet once, at a counter
// barrier over their score maxima, so every weight is exp(s - the row's
// max) as in one pass; each writes its context sums and normaliser to
// att_part, which the proj phase combines. Chunk 0 writes the fresh K/V
// rows. A K tile's 64 slots go to the 16 warps, 4 a warp, 8 lanes a
// slot; a V tile's 64 slots to 64 groups of 8 threads, 8 dims a thread,
// so each thread sums its slots in slot order.
__device__ void attention_item(const Params& P, int l, int item, AttRing& r,
                               const AttSmem& a, uint64_t* mba) {
  constexpr int kGroups = kThreads / 8;  // slot groups in the P@V phase
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = P.C, HD = P.D;
  const AttItem it(P, item);
  const int b = it.b, h = it.h, bh = b * P.H + h;
  const int c_lo = it.t0 * kAttRows, c_hi = min(C, (it.t0 + it.tn) * kAttRows);
  const float scale = 0.125f;         // 1 / sqrt(64)
  float* s = a.s;                     // s[c - c_lo] for c_lo <= c < c_hi

  const float* br = P.bias_row + (size_t)b * C;
  for (int c = c_lo + tid; c < c_hi; c += kThreads) s[c - c_lo] = br[c];
  if (tid < 3 * kDh) {  // q, k and v of this head, one channel a thread
    const int part = tid / kDh, d = tid % kDh, c = part * HD + h * kDh + d;
    const float v = part_sum(P.part_a, P.ks[MAP_ATTN], P.B, 3 * HD, b, c) *
                        P.attn_s[(size_t)l * 3 * HD + c] +
                    P.attn_b[(size_t)l * 3 * HD + c];
    const size_t row = ((size_t)l * P.B + b) * HD + h * kDh + d;
    if (part == 0) {
      a.qs[d] = v * scale;
      a.qb[d] = tt::bf16_round(v * scale);
    } else if (part == 1) {
      a.kn[d] = v;
      if (it.j == 0) P.k_rows[row] = __float2bfloat16(v);
    } else {
      a.vn[d] = v;
      if (it.j == 0) P.v_rows[row] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float t = tt::warp_sum(a.qs[lane] * a.kn[lane] +
                                 a.qs[lane + 32] * a.kn[lane + 32]);
    if (lane == 0) *a.self_s = t;
  }
  const int sub = lane >> 3, part = lane & 7;  // slot within 4, 8-dim part
  float qr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qr[i] = a.qb[part * 8 + i];
  const int g = tid >> 3, dp = tid & 7;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  float e_self = 0.f, lsum = 0.f;
  float* out = P.att_part + (size_t)item * (kDh + 2);

  for (int t = 0; t < 2 * it.tn; ++t) {
    const int st = r.done % kAttStages;
    tt::mbar_wait(&mba[st], (r.done / kAttStages) & 1);
    const __nv_bfloat16* tile = a.ring + st * kAttRows * kDh;
    const int c0 = (it.t0 + t % it.tn) * kAttRows;
    if (t < it.tn) {
      const int row = warp * 4 + sub, c = c0 + row;
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + row * kDh + part * 8);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dot += qr[2 * i] * __low2float(k2[i]) + qr[2 * i + 1] * __high2float(k2[i]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (part == 0 && c < C) s[c - c_lo] = dot + s[c - c_lo];
    } else {
      if (t == it.tn) {  // every score of the chunk is in place
        float lmax = -INFINITY;
        for (int c = c_lo + tid; c < c_hi; c += kThreads)
          lmax = fmaxf(lmax, s[c - c_lo]);
        float m = tt::block_max(lmax, a.red);
        if (P.nchunk > 1) {  // the max over the row's chunks
          if (tid == 0) {
            out[kDh + 1] = m;
            const unsigned want = (unsigned)(l + 1) * P.nchunk;
            atom_add_acq_rel(P.att_count + bh, 1u);
            while (ld_acquire(P.att_count + bh) < want) {
            }
          }
          __syncthreads();
          for (int k = 0; k < P.nchunk; ++k)
            m = fmaxf(m, __ldcg(P.att_part + ((size_t)bh * P.nchunk + k) * (kDh + 2) +
                                kDh + 1));
        }
        m = fmaxf(m, *a.self_s);
        for (int c = c_lo + tid; c < c_hi; c += kThreads) {
          const float e = expf(s[c - c_lo] - m);
          s[c - c_lo] = e;
          lsum += e;
        }
        e_self = expf(*a.self_s - m);
        __syncthreads();
      }
      const int c = c0 + g;
      if (c < C) {
        const float e = tt::bf16_round(s[c - c_lo]);
        const uint4 raw = *reinterpret_cast<const uint4*>(tile + g * kDh + dp * 8);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * i] = fmaf(e, __low2float(v2[i]), acc[2 * i]);
          acc[2 * i + 1] = fmaf(e, __high2float(v2[i]), acc[2 * i + 1]);
        }
      }
    }
    ++r.done;
    __syncthreads();  // the stage is free
    if (t + kAttStages < 2 * it.tn) attn_issue(P, l, it, t + kAttStages, r, a, mba);
  }
  const float denom = tt::block_sum(lsum, a.red);
#pragma unroll
  for (int i = 0; i < 8; ++i) a.ctxp[g * kDh + dp * 8 + i] = acc[i];
  __syncthreads();
  if (tid < kDh) {
    float ctx = 0.f;
    for (int i = 0; i < kGroups; ++i) ctx += a.ctxp[i * kDh + tid];
    if (it.j == 0) ctx += e_self * a.vn[tid];
    out[tid] = ctx;
  }
  if (tid == 0) out[kDh] = it.j == 0 ? denom + e_self : denom;
  __syncthreads();  // smem is reused by the next item
}

// (v, i) ranks before (v2, i2): the larger value, the first index on ties
// (decode_trunk.py:97).
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Sorts the n (a power of two) pairs (v, id) best first, with the whole
// block; ends synchronised.
__device__ void bitonic_sort(float* v, int* id, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int p = i ^ j;
        if (p > i && better(v[i], id[i], v[p], id[p]) == ((i & k) != 0)) {
          const float tv = v[i];
          const int ti = id[i];
          v[i] = v[p];
          id[i] = id[p];
          v[p] = tv;
          id[p] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// Sampler of row b (one block): repetition penalty on the previous token
// -> temperature -> top-k (first index wins ties) -> suffix-sum nucleus
// drop (never the top candidate) -> inverse CDF against u. The top-k:
// each warp takes the r-th largest (r = ceil(top_k / 16)) of its lanes'
// maxima; the least of these, tau, has at least 16 r >= top_k values at
// or above it, so every top-k value is >= tau. The values >= tau (about
// top_k of them) are ranked by (value, first index), the order of one
// iterative pass over all Vp values; warp 0 runs the nucleus and the CDF.
__device__ void sample_row(const Params& P, int b, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Vp = P.Vp, top_k = P.top_k;
  float* x = smem;                                   // Vp
  float* cv = x + kMaxVp;                            // kSortCap
  int* ci = reinterpret_cast<int*>(cv + kSortCap);   // kSortCap
  float* sv = reinterpret_cast<float*>(ci + kSortCap);  // top_k, sorted
  int* si = reinterpret_cast<int*>(sv + kMaxTopK);
  float* wb = reinterpret_cast<float*>(si + kMaxTopK);  // kWarps bounds
  int* count = reinterpret_cast<int*>(wb + kWarps);

  const float* lg = P.logits + (size_t)b * Vp;
#pragma unroll 4
  for (int i = tid; i < Vp; i += kThreads) x[i] = __ldcg(lg + i);
  const int pv = P.prev[b];
  float tmax = -INFINITY;
  for (int i = tid; i < Vp; i += kThreads) {
    float v = x[i];
    if (i == pv) v = v < 0.f ? v * P.penalty : v / P.penalty;
    v *= P.inv_temp;
    x[i] = v;
    tmax = fmaxf(tmax, v);
  }
  const int r = (top_k + kWarps - 1) / kWarps;
  float wr = -INFINITY;
  for (int it = 0; it < r; ++it) {
    wr = tt::warp_max(tmax);
    const unsigned hit = __ballot_sync(0xffffffffu, tmax == wr);
    if (hit && lane == __ffs(hit) - 1) tmax = -INFINITY;
  }
  if (lane == 0) wb[warp] = wr;
  if (tid == 0) *count = 0;
  __syncthreads();
  float tau = wb[0];
  for (int w = 1; w < kWarps; ++w) tau = fminf(tau, wb[w]);
  for (int i = tid; i < Vp; i += kThreads) {
    if (x[i] >= tau) {
      const int slot = atomicAdd(count, 1);
      cv[slot] = x[i];
      ci[slot] = i;
    }
  }
  __syncthreads();
  const int n = *count;
  if (n <= kThreads) {
    // rank of each candidate among the others
    if (tid < n) {
      const float v = cv[tid];
      const int id = ci[tid];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += better(cv[j], ci[j], v, id);
      if (rank < top_k) {
        sv[rank] = v;
        si[rank] = id;
      }
    }
  } else {  // many ties at tau: sort them all
    int np = kThreads;
    while (np < n) np <<= 1;
    for (int i = n + tid; i < np; i += kThreads) {
      cv[i] = -INFINITY;
      ci[i] = 0x7fffffff;
    }
    __syncthreads();
    bitonic_sort(cv, ci, np);
    for (int c = tid; c < top_k; c += kThreads) {
      sv[c] = cv[c];
      si[c] = ci[c];
    }
  }
  __syncthreads();

  if (warp == 0) {
    // lane l holds candidates 4l .. 4l + 3 (top_k <= 128); sv[0] is the
    // max of the candidates and, since #0 is never dropped, of the kept
    // ones too
    constexpr int kPer = kMaxTopK / 32;
    float p[kPer];
    float own = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = kPer * lane + k;
      p[k] = c < top_k ? expf(sv[c] - sv[0]) : 0.f;
      own += p[k];
    }
    const float sum = tt::warp_sum(own);
    // suffix sums of p / sum from the last candidate down
    float mine = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) mine += p[k] / sum;
    float incl = mine;  // inclusive suffix scan over lanes
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float suffix = incl - mine, own2 = 0.f;  // from the lanes above
#pragma unroll
    for (int k = kPer - 1; k >= 0; --k) {
      const int c = kPer * lane + k;
      suffix += p[k] / sum;
      if (c > 0 && suffix <= P.top_p_drop) p[k] = 0.f;
      own2 += p[k];
    }
    const float sum2 = tt::warp_sum(own2);
    float mine2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) mine2 += p[k] / sum2;
    float incl2 = mine2;  // inclusive prefix scan over lanes
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl2, o);
      if (lane >= o) incl2 += t;
    }
    float cum = incl2 - mine2;
    int cnt = 0;
    const float u = P.u[b];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = kPer * lane + k;
      cum += p[k] / sum2;
      cnt += c < top_k && cum < u;
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lane == 0) P.tok[b] = si[min(cnt, top_k - 1)];
  }
  __syncthreads();  // smem is reused by the next row
}

__global__ void __launch_bounds__(kThreads, 1)
decode_step_kernel(const __grid_constant__ Params P) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the TMA swizzle): the mbarriers, the weight tile,
  // the operand rows, then the other phases' working memory
  uint8_t* base = smem_raw + ((1024 - (tt::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* mbw = reinterpret_cast<uint64_t*>(base);
  uint64_t* mby = mbw + 4;
  uint64_t* mba = mby + 1;  // kAttStages
  uint8_t* ws = base + 1024;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(ws + kMaxRows * kTileN);
  const AttSmem att(reinterpret_cast<float*>(ys + kMaxB * (kMaxRows + 8)));
  unsigned wl = 0, yl = 0;  // weight tiles and operand loads waited on
  AttRing ar;
  if (threadIdx.x == 0) {
    for (int q = 0; q < 5 + kAttStages; ++q) tt::mbar_init(&mbw[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int L = P.L, B = P.B, D = P.D, F = P.F, H = P.H, C = P.C;
  const bool head = P.lm_wq != nullptr;
  const size_t cache_layer = (size_t)B * C * D * 2;  // bytes of K or V
  const bool warm_cache = 2 * cache_layer <= (size_t)16 << 20;
  auto warm_layer = [&](int l) {
    prefetch_l2(P.fp_w + (size_t)l * F * D, (size_t)F * D);
    const float* vecs[][2] = {{P.ln1_w, P.ln1_b}, {P.ln2_w, P.ln2_b},
                              {P.proj_s, P.proj_b}, {P.fp_s, P.fp_b}};
    for (auto& v : vecs) {
      prefetch_l2(v[0] + (size_t)l * D, (size_t)D * 4);
      prefetch_l2(v[1] + (size_t)l * D, (size_t)D * 4);
    }
    prefetch_l2(P.attn_s + (size_t)l * 3 * D, (size_t)D * 12);
    prefetch_l2(P.attn_b + (size_t)l * 3 * D, (size_t)D * 12);
    prefetch_l2(P.fc_s + (size_t)l * F, (size_t)F * 4);
    prefetch_l2(P.fc_b + (size_t)l * F, (size_t)F * 4);
    if (warm_cache) {
      prefetch_l2(P.cache_k + (size_t)l * B * C * D, cache_layer);
      prefetch_l2(P.cache_v + (size_t)l * B * C * D, cache_layer);
    }
  };

  int nsync = 0;
  unsigned gen = *reinterpret_cast<volatile unsigned*>(P.bar + 1);
  if (P.trace && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    P.trace[0] = t;
  }
  const Matvec lm{MAP_LM, 0, D, P.Vp};
  int* flag = att.flag;
  issue_weights(P, Matvec{MAP_ATTN, 0, D, 3 * D}, blockIdx.x, ws, mbw);
  warm_layer(0);
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    row_phase(P, b, ROW_LN, P.ln1_w, P.ln1_b, att.red);
  grid_sync(P, nsync, gen);
  for (int l = 0; l < L; ++l) {
    const bool last = l + 1 == L;
    const Matvec qkv{MAP_ATTN, l, D, 3 * D}, proj{MAP_PROJ, l, D, D},
        fc{MAP_FC, l, D, F}, fp{MAP_FP, l, F, D},
        qkv_next{MAP_ATTN, l + 1, D, 3 * D};
    matvec_phase(P, qkv, P.y, P.part_a, &proj, ws, ys, mbw, mby, wl, yl, flag);
    attn_prologue(P, l, blockIdx.x, ar, att, mba);
    grid_sync(P, nsync, gen);
    for (int it = blockIdx.x; it < B * H * P.nchunk; it += gridDim.x) {
      if (it != blockIdx.x) attn_prologue(P, l, it, ar, att, mba);
      attention_item(P, l, it, ar, att, mba);
    }
    if (!last) {
      warm_layer(l + 1);
    } else if (head) {
      prefetch_l2(P.lm_sc, (size_t)P.Vp * 4);
      prefetch_l2(P.lm_b, (size_t)P.Vp * 4);
    }
    grid_sync(P, nsync, gen);
    if (last)  // every group's counter is done with: ready for the next step
      for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * H;
           i += gridDim.x * kThreads)
        P.att_count[i] = 0u;
    matvec_phase(P, proj, nullptr, P.part_b, &fc, ws, ys, mbw, mby, wl, yl,
                 flag, FIN_RESID, P.proj_s + (size_t)l * D,
                 P.proj_b + (size_t)l * D);
    grid_sync(P, nsync, gen);
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      row_phase(P, b, ROW_LN, P.ln2_w + (size_t)l * D, P.ln2_b + (size_t)l * D,
                att.red);
    grid_sync(P, nsync, gen);
    matvec_phase(P, fc, P.y, P.part_a, &fp, ws, ys, mbw, mby, wl, yl, flag,
                 FIN_GELU, P.fc_s + (size_t)l * F, P.fc_b + (size_t)l * F);
    grid_sync(P, nsync, gen);
    matvec_phase(P, fp, P.hdn, P.part_b, last ? &lm : &qkv_next, ws, ys, mbw,
                 mby, wl, yl, flag, FIN_RESID, P.fp_s + (size_t)l * D,
                 P.fp_b + (size_t)l * D);
    if (last && !head) return;  // x holds the final hidden state
    grid_sync(P, nsync, gen);
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      row_phase(P, b, last ? ROW_HEAD : ROW_LN,
                last ? nullptr : P.ln1_w + (size_t)(l + 1) * D,
                last ? nullptr : P.ln1_b + (size_t)(l + 1) * D, att.red);
    grid_sync(P, nsync, gen);
  }
  matvec_phase(P, lm, P.y, P.part_a, nullptr, ws, ys, mbw, mby, wl, yl, flag,
               FIN_LOGITS, P.lm_sc, P.lm_b);
  if (!P.tok) return;
  grid_sync(P, nsync, gen);
  // the sampler's working memory starts at the (now unused) weight tile
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    sample_row(P, b, reinterpret_cast<float*>(ws));
  if (P.trace) grid_sync(P, nsync, gen);
}

size_t smem_bytes() {
  // the weight tile and the operand rows, then the attention's memory
  // (whose reduction scratch the row phases use); or the sampler's from
  // the weight tile on
  const size_t mv = (size_t)kMaxRows * kTileN + 2 * kMaxB * (kMaxRows + 8);
  const size_t att = (size_t)kAttStages * kAttRows * kDh * 2 +
                     sizeof(float) * (kMaxC + 4 * kDh + 64 + (kThreads / 8) * kDh);
  const size_t smp = sizeof(float) * (kMaxVp + 2 * kSortCap + 2 * kMaxTopK + kWarps + 1);
  size_t m = mv + att;
  m = m > smp ? m : smp;
  return 2048 + m;  // + the alignment and the mbarriers' 1024 bytes
}

// Blocks of one step: as many as the card holds at once.
cudaError_t grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  const size_t smem = smem_bytes();
  if ((err = cudaFuncSetAttribute(decode_step_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_step_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// Split of a K x N matvec's rows: the largest power of two whose items
// (N / 128 column tiles x ks) still fit the grid once, with K / ks a
// multiple of kMinRows and at most kMaxRows; 0 when no split fits.
int row_split(int K, int N, int grid) {
  if (N % kTileN || K % kMinRows) return 0;
  const int tiles = N / kTileN;
  int ks = 1;
  while (2 * ks <= kMaxSplit && K % (2 * ks * kMinRows) == 0 &&
         tiles * 2 * ks <= grid)
    ks *= 2;
  while (2 * ks <= kMaxSplit && K / ks > kMaxRows &&
         K % (2 * ks * kMinRows) == 0)
    ks *= 2;
  return K / ks <= kMaxRows ? ks : 0;
}

// The step's scratch (floats, zeroed once by the caller): the two
// partial-sum buffers, hdn (B, F) bf16, the attention items' sums (at most
// max(B * H, grid) items of 66 floats), then the counters: the column
// tiles' (fc and the lm head take turns with them), the attention
// groups', and the barrier's 2 words. Every launch leaves the counters at
// zero. Vp = 0 without the head; floats() < 0 on a shape the kernel does
// not take.
struct Scratch {
  long long most = -1, hdn = 0, att = 0, tiles = 0, groups = 0;
  Scratch(int B, int D, int F, int Vp, int grid) {
    const int shapes[kMaps][2] = {{D, 3 * D}, {D, D}, {D, F}, {F, D}, {D, Vp}};
    long long m = 0;
    for (int i = 0; i < kMaps; ++i) {
      if (i == MAP_LM && Vp == 0) continue;
      const int ks = row_split(shapes[i][0], shapes[i][1], grid);
      if (ks == 0) return;
      const long long n = (long long)ks * B * shapes[i][1];
      m = n > m ? n : m;
    }
    most = m;
    hdn = ((long long)B * F + 1) / 2;
    groups = (long long)B * (D / kDh);
    att = (groups > grid ? groups : grid) * (kDh + 2);
    tiles = (F > Vp ? F : Vp) / kTileN;
    tiles = D / kTileN > tiles ? D / kTileN : tiles;
  }
  long long floats() const {
    return most < 0 ? -1 : 2 * most + hdn + att + tiles + groups + 2;
  }
};

// The split of the cache attention of one (row, head): while the B * H
// groups leave blocks idle, each takes as many blocks as there are (at
// most one a tile of kAttRows slots), so all its items run at once.
void att_split(int B, int H, int C, int grid, int* nchunk, int* ct) {
  const int nt = (C + kAttRows - 1) / kAttRows;
  int n = B * H <= grid ? grid / (B * H) : 1;
  n = n < nt ? n : nt;
  *ct = (nt + n - 1) / n;
  *nchunk = (nt + *ct - 1) / *ct;
}

unsigned long long* g_trace = nullptr;

}  // namespace

// Profiling hook: with a non-null buffer of 4096 u64, every later step
// records the global timer at its start (entry 0), at block 0's exit from
// each barrier (entries 1..) and, from entry 2048, the last block's
// arrival at each barrier (with the sampler, one more barrier closes the
// step); null turns it off.
TT_EXPORT void tt_decode_set_trace(unsigned long long* buf) { g_trace = buf; }

// Scratch floats the step needs besides its outputs (struct Scratch);
// -1 on a shape the kernel does not take.
TT_EXPORT long long tt_decode_partial_floats(int B, int D, int F, int Vp) {
  int grid = 0;
  if (grid_blocks(&grid) != cudaSuccess) return -1;
  return Scratch(B, D, F, Vp, grid).floats();
}

// The whole decode step in one cooperative launch. x (B, D) f32 holds the
// embedded input and is updated in place into the final hidden state.
// Stacked per-layer weights: ln (L, D); int8 weights (L, in, out) with
// scales (L, 1, out) and biases (L, out). Cache K/V (L, B, C, D) bf16; the
// fresh rows go to k_rows/v_rows (L, B, D) bf16. Head (lm_wq non-null):
// ln_f, lm_ln (D,), int8 lm_wq (D, Vp), lm_sc, lm_b (Vp,) -> logits
// (B, Vp) f32. Sampler (tok non-null): prev (B,) int32, u (B,) f32 -> tok
// (B,) int32. Scratch: y (B, D) bf16; partial
// (tt_decode_partial_floats(B, D, F, Vp) zeroed floats). split_b: the
// batch whose split of the cache attention to take (<= B: B's own).
TT_EXPORT int tt_decode_trunk(
    int L, int B, int C, int D, int H, int F, int split_b, float eps, float* x,
    const float* bias_row, const float* ln1_w, const float* ln1_b,
    const int8_t* attn_w, const float* attn_s, const float* attn_b,
    const int8_t* proj_w, const float* proj_s, const float* proj_b,
    const float* ln2_w, const float* ln2_b, const int8_t* fc_w,
    const float* fc_s, const float* fc_b, const int8_t* fp_w,
    const float* fp_s, const float* fp_b, const void* cache_k,
    const void* cache_v, void* k_rows, void* v_rows, int Vp,
    const float* lnf_w, const float* lnf_b, const float* lmln_w,
    const float* lmln_b, const int8_t* lm_wq, const float* lm_sc,
    const float* lm_b, float* logits, const int* prev, const float* u,
    float inv_temp, int top_k, float top_p_drop, float penalty, int* tok,
    void* y_buf, float* partial, cudaStream_t stream) {
  if (B < 1 || B > kMaxB || D != H * kDh || D > kRowCols * kThreads || C < 1 ||
      C > kMaxC)
    return (int)cudaErrorInvalidValue;
  if (lm_wq && Vp > kMaxVp) return (int)cudaErrorInvalidValue;
  if (tok && (top_k < 1 || top_k > kMaxTopK || top_k > Vp || !lm_wq))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_blocks(&grid);
  if (err != cudaSuccess) return (int)err;
  const Scratch scr(B, D, F, lm_wq ? Vp : 0, grid);
  if (scr.floats() < 0) return (int)cudaErrorInvalidValue;
  Params P;
  P.L = L; P.B = B; P.C = C; P.D = D; P.H = H; P.F = F; P.Vp = Vp;
  P.eps = eps; P.x = x; P.bias_row = bias_row;
  P.ln1_w = ln1_w; P.ln1_b = ln1_b;
  P.attn_w = attn_w; P.attn_s = attn_s; P.attn_b = attn_b;
  P.proj_w = proj_w; P.proj_s = proj_s; P.proj_b = proj_b;
  P.ln2_w = ln2_w; P.ln2_b = ln2_b;
  P.fc_w = fc_w; P.fc_s = fc_s; P.fc_b = fc_b;
  P.fp_w = fp_w; P.fp_s = fp_s; P.fp_b = fp_b;
  P.cache_k = static_cast<const __nv_bfloat16*>(cache_k);
  P.cache_v = static_cast<const __nv_bfloat16*>(cache_v);
  P.k_rows = static_cast<__nv_bfloat16*>(k_rows);
  P.v_rows = static_cast<__nv_bfloat16*>(v_rows);
  P.lnf_w = lnf_w; P.lnf_b = lnf_b; P.lmln_w = lmln_w; P.lmln_b = lmln_b;
  P.lm_wq = lm_wq; P.lm_sc = lm_sc; P.lm_b = lm_b; P.logits = logits;
  P.prev = prev; P.u = u; P.inv_temp = inv_temp; P.top_k = top_k;
  P.top_p_drop = top_p_drop; P.penalty = penalty; P.tok = tok;
  P.y = static_cast<__nv_bfloat16*>(y_buf);
  P.part_a = partial;
  P.part_b = partial + scr.most;
  P.hdn = reinterpret_cast<__nv_bfloat16*>(partial + 2 * scr.most);
  P.att_part = partial + 2 * scr.most + scr.hdn;
  P.tile_count = reinterpret_cast<unsigned*>(P.att_part + scr.att);
  P.att_count = P.tile_count + scr.tiles;
  P.bar = P.att_count + scr.groups;
  att_split(split_b > B ? split_b : B, H, C, grid, &P.nchunk, &P.ct);
  P.trace = g_trace;

  // the weights as (out, in, layer) int8 tensors, in boxes of 128 columns
  // by a quarter of a matvec item's input rows, 128-byte swizzled
  tt::EncodeTiled encode = tt::encode_tiled();
  if (!encode) return (int)cudaErrorInvalidValue;
  const struct {
    const int8_t* w;
    int k, n, layers;
  } maps[kMaps] = {{attn_w, D, 3 * D, L},
                   {proj_w, D, D, L},
                   {fc_w, D, F, L},
                   {fp_w, F, D, L},
                   {lm_wq, D, Vp, 1}};
  for (int i = 0; i < kMaps; ++i) {
    P.ks[i] = 0;
    if (!maps[i].w) continue;
    P.ks[i] = row_split(maps[i].k, maps[i].n, grid);
    const cuuint64_t dims[3] = {(cuuint64_t)maps[i].n, (cuuint64_t)maps[i].k,
                                (cuuint64_t)maps[i].layers};
    const cuuint64_t strides[2] = {(cuuint64_t)maps[i].n,
                                   (cuuint64_t)maps[i].n * maps[i].k};
    const cuuint32_t box[3] = {kTileN, (cuuint32_t)(maps[i].k / P.ks[i] / 4), 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&P.wmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
               const_cast<int8_t*>(maps[i].w), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  // the cache K and V as (D, C, L * B) bf16, in boxes of one head's 64
  // dims by kAttRows slots; slots past C read as zeros
  const void* caches[2] = {cache_k, cache_v};
  CUtensorMap* cmaps[2] = {&P.kmap, &P.vmap};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)C,
                                (cuuint64_t)L * B};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)C * D * 2};
    const cuuint32_t box[3] = {kDh, kAttRows, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(cmaps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(caches[i]), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decode_step_kernel), dim3(grid),
      dim3(kThreads), args, smem_bytes(), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
