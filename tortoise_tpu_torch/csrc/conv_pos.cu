// Kernel CP: F5-TTS's ConvPositionEmbedding in one launch, on wgmma.
//
// Replaces no Pallas kernel: the JAX package has no F5. It was added
// because the eager chain (a mask, a transpose, cuDNN's grouped conv, a
// transpose back, Mish, the same again, a mask and the residual add) took
// 0.47 ms at (2, 1280, 1024) on an H100, ~4% of its bound: cuDNN runs 16
// per-group kernels a conv, and every pass reads and writes the whole
// (B, T, 1024) bf16 map.
//
// What it computes, over a time-major h (B, T, G*64) bf16 and a frame
// mask (frames outside it and outside [0, T) read as zeros):
//   out = h + zero(mish(conv2(zero(mish(conv1(zero(h)))))))
// with conv1 and conv2 grouped (G groups of 64 channels), k = 31, "same"
// zero padding, and the eager chain's roundings: each conv sums in f32,
// adds its bf16 bias and rounds to bf16; Mish is x tanh(log1p(e^x)) in
// f32 on that value, rounded to bf16; the residual add rounds to bf16.
//
// What bounds it on the card: 2 convs x 2 B T 1024 x 64 x 31 FLOPs (20.8
// GFLOP at B = 2, T = 1,280: ~21 us at 989 TFLOP/s) against ~18.5 MB of
// bytes (h in, out, both convs' weights: ~5.6 us). So the tensor cores,
// and the shared-memory traffic that feeds them: at N = 64 output
// channels a group, each wgmma.m64n64k16 reads its 2 KB A and 2 KB B
// from shared memory, which is the SM's 128 bytes a clock at the tensor
// cores' full rate. The halo and the 64-row tiles make a block compute
// 2 x 192 rows for its 162 output frames, 19% over the FLOPs counted.
//
// Design (Hopper): the groups are independent through both convs, so one
// block owns one (CFG row b, group g, tile of kTile = 162 output frames)
// and nothing crosses blocks.
// - The consumers (3 warpgroups) load the tile's input, frames t0 - 30
//   .. t0 + 191 of the group's 64 channels, with zeros outside [0, T)
//   and at masked frames, into shared memory rows of 144 bytes (the pad
//   puts ldmatrix's 8 rows on distinct banks at any row offset).
// - conv1 runs as an implicit GEMM over kM = 192 rows (frames t0 - 15 ..
//   t0 + 176, 64 a warpgroup): K = 31 taps x 64 channels, tap j's A the
//   input rows shifted by j, read into registers by ldmatrix (the mma
//   fragment layout, which wgmma takes for a register A), against tap
//   j's 64 x 64 weight tile as B. Its epilogue (bias, bf16, Mish, bf16,
//   the mask) writes y1 to a second tile in shared memory.
// - conv2 runs the same way over y1, 192 rows of which the first 162 are
//   the tile's output frames; its epilogue adds bias, Mish and the mask,
//   adds h (read back from the input tile, or from h itself at masked
//   frames, where the input tile holds zeros) and stores once.
// - One conv's weights for one group are 254 KB, more than a block's
//   shared memory, so a producer warp streams the 62 tap tiles (8 KB
//   each: conv1's 31, then conv2's) through an 8-stage ring with 1-D bulk
//   copies completing on mbarriers; the consumer warps release a stage
//   when the wgmma that read it has retired. The tiles are laid out once
//   in prepare() (ops/cuda/conv_pos.py weight_tiles): (in, out) per tap,
//   each 128-byte row's 16-byte chunks permuted as the 128-byte swizzle
//   puts them, which is the layout wgmma reads an MN-major B in.
// - Each warpgroup keeps one tap's products in flight: it issues tap j's
//   4 wgmmas (A from registers, 64 x 64 x 16 each), waits for tap j - 1's,
//   and loads tap j + 1's A fragments into the other register set.
// Products: wgmma.m64n64k16 bf16 with f32 accumulators.
//
// The SIMT body (conv_pos_simt) runs what the wgmma body does not: the
// f32 plane (an f32 map, weights and sums, the eager chain's f32 convs
// with TF32 off) and the tiny configs' groups of 16 channels, in bf16 or
// f32. Same block ownership and the same two convs with y1 in shared
// memory, on FMAs: 256 threads, each holding a 4 x (C / 8) accumulator
// tile of a conv's 128 rows, one tap's plain (in, out) weight tile
// staged in shared memory at a time. Neither plane runs in a benchmark
// cell; this body is for correctness at a fair speed, not for the roof.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kC = 64;                  // channels of a group
constexpr int kK = 31;                  // taps
constexpr int kHalo = kK / 2;           // "same" padding
constexpr int kWG = 3;                  // consumer warpgroups
constexpr int kConsumers = kWG * 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kM = kWG * 64;            // rows each conv computes
constexpr int kTile = kM - 2 * kHalo;   // output frames a block
constexpr int kRows = kM + 2 * kHalo;   // rows of the x and y1 tiles
constexpr int kLd = kC + 8;             // row pitch (bf16): 144 bytes
constexpr int kStages = 8;              // weight ring depth
constexpr unsigned kTapBytes = kC * kC * 2;
constexpr int kOffX = kStages * kTapBytes;         // ring first (aligned)
constexpr int kOffY = kOffX + kRows * kLd * 2;
constexpr int kOffBar = kOffY + kRows * kLd * 2;
constexpr size_t kSmem = 1024 + kOffBar + 2 * kStages * sizeof(uint64_t);
constexpr int kConsumerBar = 1;         // named barrier of the consumers

// d += A (registers, the mma fragment layout) * B (smem, MN-major), 64 x
// 64 x 16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t a[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the A fragments of one tap: 4 k-steps of 16 channels over this warp's
// 16 rows, `p` this lane's row (lane % 16) at column 8 (lane / 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const __nv_bfloat16* p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(tt::smem_u32(p + 16 * kk))
        : "memory");
}

// one conv over this warpgroup's 64 rows: acc = sum over the taps of the
// source rows shifted by the tap against the ring's tap tiles q0 .. q0 +
// 30; `src` is this lane's first A row
__device__ __forceinline__ void conv_rows(float (&acc)[32],
                                          const __nv_bfloat16* src,
                                          const uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, int q0, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];
  load_a(a[0], src);
#pragma unroll
  for (int tap = 0; tap < kK; ++tap) {
    const int q = q0 + tap, st = q % kStages;
    tt::mbar_wait(&full[st], (q / kStages) & 1);
    const uint64_t db = tt::wgmma_desc<128>(ring + st * kTapBytes);
    tt::fence_regs(acc);
    tt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 input channels a step
      wgmma_rs(acc, a[tap & 1][kk], db + ((kk * 16 * 128) >> 4));
    tt::wgmma_commit();
    tt::wgmma_wait<1>();  // tap - 1's products have retired
    tt::fence_regs(acc);
    if (tap > 0) {
      __syncwarp();
      if (lane == 0) tt::mbar_arrive(&empty[(q - 1) % kStages]);
    }
    if (tap + 1 < kK) load_a(a[(tap + 1) & 1], src + (tap + 1) * kLd);
  }
  tt::wgmma_wait<0>();
  tt::fence_regs(acc);
  __syncwarp();
  if (lane == 0) tt::mbar_arrive(&empty[(q0 + kK - 1) % kStages]);
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// x rounded to E (a float again)
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<E, float>::value) return x;
  else return tt::bf16_round(x);
}
template <typename E>
__device__ __forceinline__ E store_as(float x) {
  if constexpr (std::is_same<E, float>::value) return x;
  else return __float2bfloat16_rn(x);
}

// Mish of a conv's sum plus bias as the eager chain forms it in E: the
// sum rounded to E, x tanh(log1p(e^x)) in f32 on it, rounded to E
template <typename E>
__device__ __forceinline__ float mish_in(float acc, float bias) {
  const float x = round_to<E>(acc + bias);
  return round_to<E>(x * tanhf(log1pf(expf(x))));
}

__global__ void __launch_bounds__(kThreads, 1)
conv_pos_kernel(const __nv_bfloat16* __restrict__ h,
                const uint8_t* __restrict__ mask, long long mask_stride,
                const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2,
                const __nv_bfloat16* __restrict__ b2,
                __nv_bfloat16* __restrict__ out, int T, int G) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (tt::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kOffX);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + kOffY);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;

  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  const int C = G * kC;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tt::mbar_init(&full[s], 1);
      tt::mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one lane streams conv1's tap tiles, then conv2's
    if (tid == kConsumers) {
      for (int q = 0; q < 2 * kK; ++q) {
        const int st = q % kStages, n = q / kStages;
        if (n > 0) tt::mbar_wait(&empty[st], (n - 1) & 1);
        const __nv_bfloat16* src =
            (q < kK ? w1 : w2) + ((size_t)g * kK + q % kK) * kC * kC;
        tt::mbar_expect_tx(&full[st], kTapBytes);
        tt::bulk_load(ring + st * kTapBytes, src, kTapBytes, &full[st]);
      }
    }
    return;
  }

  const uint8_t* mask_b = mask ? mask + b * mask_stride : nullptr;
  auto kept = [&](int f) {
    return f >= 0 && f < T && (!mask_b || mask_b[f]);
  };
  // the input tile: row i is frame t0 - 2 kHalo + i, 8 chunks of 16 bytes
  const __nv_bfloat16* hb = h + (size_t)b * T * C + g * kC;
  for (int x = tid; x < kRows * 8; x += kConsumers) {
    const int i = x >> 3, c = (x & 7) * 8, f = t0 - 2 * kHalo + i;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (kept(f)) v = *reinterpret_cast<const uint4*>(hb + (size_t)f * C + c);
    *reinterpret_cast<uint4*>(xs + i * kLd + c) = v;
  }
  // y1's rows past kM feed only conv2's rows past kTile (never stored)
  for (int x = tid; x < (kRows - kM) * 8; x += kConsumers)
    *reinterpret_cast<uint4*>(ys + (kM + (x >> 3)) * kLd + (x & 7) * 8) =
        make_uint4(0, 0, 0, 0);
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers));

  // warpgroup wg owns rows 64 wg .. + 63 of each conv; this thread holds
  // rows r0 and r0 + 8, channels 8 j + 2 tg (+1) of the accumulator
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tg = lane & 3;
  const int rw = wg * 64 + warp * 16;  // this warp's first row
  const int r0 = rw + gid;
  const int a_off = (rw + (lane & 15)) * kLd + (lane >> 4) * 8;
  float acc[32];

  // conv1 -> y1 over frames t0 - kHalo + r
  conv_rows(acc, xs + a_off, ring, full, empty, 0, lane);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const bool keep = kept(t0 - kHalo + r);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * tg;
      uint32_t v = 0;
      if (keep)
        v = tt::pack_bf16(
            mish_in<__nv_bfloat16>(acc[4 * j + 2 * half],
                                   __bfloat162float(b1[g * kC + n])),
            mish_in<__nv_bfloat16>(acc[4 * j + 2 * half + 1],
                                   __bfloat162float(b1[g * kC + n + 1])));
      *reinterpret_cast<uint32_t*>(ys + r * kLd + n) = v;
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers));

  // conv2 -> out over frames t0 + r, r < kTile
  conv_rows(acc, ys + a_off, ring, full, empty, kK, lane);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half, f = t0 + r;
    if (r >= kTile || f >= T) continue;
    const bool keep = kept(f);
    __nv_bfloat16* orow = out + ((size_t)b * T + f) * C + g * kC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * tg;
      float y0 = 0.f, y1 = 0.f, h0, h1;
      if (keep) {
        y0 = mish_in<__nv_bfloat16>(acc[4 * j + 2 * half],
                                    __bfloat162float(b2[g * kC + n]));
        y1 = mish_in<__nv_bfloat16>(acc[4 * j + 2 * half + 1],
                                    __bfloat162float(b2[g * kC + n + 1]));
        const __nv_bfloat16* hx = xs + (r + 2 * kHalo) * kLd + n;
        h0 = __bfloat162float(hx[0]);
        h1 = __bfloat162float(hx[1]);
      } else {  // the tile holds zeros here; h + 0 as the chain adds it
        const __nv_bfloat16* hx = hb + (size_t)f * C + n;
        h0 = __bfloat162float(hx[0]);
        h1 = __bfloat162float(hx[1]);
      }
      *reinterpret_cast<uint32_t*>(orow + n) = tt::pack_bf16(h0 + y0, h1 + y1);
    }
  }
}

// ---- the SIMT body ----
constexpr int kSimtThreads = 256;
constexpr int kSimtRT = 4;                      // rows a thread
constexpr int kSimtM = kSimtThreads / 8 * kSimtRT;  // rows each conv computes
constexpr int kSimtTile = kSimtM - 2 * kHalo;   // output frames a block
constexpr int kSimtRows = kSimtM + 2 * kHalo;   // rows of the x and y1 tiles

// floats a tile row: rows 4 apart fall 4 banks apart
template <int kW>
__host__ __device__ constexpr int simt_pitch() {
  return kW + 1;
}
template <int kW>
constexpr size_t simt_smem() {
  return (2 * kSimtRows * simt_pitch<kW>() + kW * kW) * sizeof(float);
}

// one conv over the block's kSimtM rows: acc[r][k] (row 4 rg + r,
// channel cg + 8 k) = sum over the taps j and input channels i of src
// row (4 rg + r + j) channel i times tap j's weight (i, out); `w` the
// group's 31 plain (in, out) tap tiles. Syncs before it reads src.
template <typename E, int kW>
__device__ __forceinline__ void conv_simt(float (&acc)[kSimtRT][kW / 8],
                                          const float* src, float* ws,
                                          const E* w, int rg, int cg,
                                          int tid) {
  constexpr int kP = simt_pitch<kW>();
#pragma unroll
  for (int r = 0; r < kSimtRT; ++r)
#pragma unroll
    for (int k = 0; k < kW / 8; ++k) acc[r][k] = 0.f;
  for (int tap = 0; tap < kK; ++tap) {
    __syncthreads();  // src written; the last tap's reads of ws done
    for (int x = tid; x < kW * kW; x += kSimtThreads)
      ws[x] = as_f32(w[(size_t)tap * kW * kW + x]);
    __syncthreads();
    const float* xr = src + (rg * kSimtRT + tap) * kP;
#pragma unroll 4
    for (int i = 0; i < kW; ++i) {
      float xv[kSimtRT], wv[kW / 8];
#pragma unroll
      for (int r = 0; r < kSimtRT; ++r) xv[r] = xr[r * kP + i];
#pragma unroll
      for (int k = 0; k < kW / 8; ++k) wv[k] = ws[i * kW + cg + 8 * k];
#pragma unroll
      for (int r = 0; r < kSimtRT; ++r)
#pragma unroll
        for (int k = 0; k < kW / 8; ++k)
          acc[r][k] = fmaf(xv[r], wv[k], acc[r][k]);
    }
  }
}

template <typename E, int kW>
__global__ void __launch_bounds__(kSimtThreads)
conv_pos_simt(const E* __restrict__ h, const uint8_t* __restrict__ mask,
              long long mask_stride, const E* __restrict__ w1,
              const E* __restrict__ b1, const E* __restrict__ w2,
              const E* __restrict__ b2, E* __restrict__ out, int T, int G) {
  constexpr int kP = simt_pitch<kW>();
  extern __shared__ float smem_f[];
  float* xs = smem_f;                 // row i: frame t0 - 2 kHalo + i
  float* ys = xs + kSimtRows * kP;    // row i: frame t0 - kHalo + i
  float* ws = ys + kSimtRows * kP;    // one tap's (in, out) tile

  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = blockIdx.x * kSimtTile, C = G * kW;
  const uint8_t* mask_b = mask ? mask + b * mask_stride : nullptr;
  auto kept = [&](int f) {
    return f >= 0 && f < T && (!mask_b || mask_b[f]);
  };
  const E* hb = h + (size_t)b * T * C + g * kW;
  for (int x = tid; x < kSimtRows * kW; x += kSimtThreads) {
    const int i = x / kW, c = x % kW, f = t0 - 2 * kHalo + i;
    xs[i * kP + c] = kept(f) ? as_f32(hb[(size_t)f * C + c]) : 0.f;
    // y1's rows past kSimtM feed only conv2's rows past the tile
    if (i >= kSimtM) ys[i * kP + c] = 0.f;
  }
  const int cg = tid & 7, rg = tid >> 3;
  float acc[kSimtRT][kW / 8];

  // conv1 -> y1
  conv_simt<E, kW>(acc, xs, ws, w1 + (size_t)g * kK * kW * kW, rg, cg, tid);
#pragma unroll
  for (int r = 0; r < kSimtRT; ++r) {
    const int row = rg * kSimtRT + r;
    const bool keep = kept(t0 - kHalo + row);
#pragma unroll
    for (int k = 0; k < kW / 8; ++k) {
      const int n = cg + 8 * k;
      ys[row * kP + n] =
          keep ? mish_in<E>(acc[r][k], as_f32(b1[g * kW + n])) : 0.f;
    }
  }

  // conv2 -> out over frames t0 + row, row < kSimtTile
  conv_simt<E, kW>(acc, ys, ws, w2 + (size_t)g * kK * kW * kW, rg, cg, tid);
#pragma unroll
  for (int r = 0; r < kSimtRT; ++r) {
    const int row = rg * kSimtRT + r, f = t0 + row;
    if (row >= kSimtTile || f >= T) continue;
    const bool keep = kept(f);
    E* orow = out + ((size_t)b * T + f) * C + g * kW;
#pragma unroll
    for (int k = 0; k < kW / 8; ++k) {
      const int n = cg + 8 * k;
      // the tile holds zeros at masked frames; h + 0 as the chain adds it
      const float hv = keep ? xs[(row + 2 * kHalo) * kP + n]
                            : as_f32(hb[(size_t)f * C + n]);
      const float y =
          keep ? mish_in<E>(acc[r][k], as_f32(b2[g * kW + n])) : 0.f;
      orow[n] = store_as<E>(hv + y);
    }
  }
}

template <typename E, int kW>
cudaError_t launch_simt(const void* h, const uint8_t* mask, long long ms,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int B, int T, int G,
                        cudaStream_t stream) {
  static tt::KernelFacts facts;
  const cudaError_t err = facts.allow_smem(
      reinterpret_cast<const void*>(conv_pos_simt<E, kW>));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kSimtTile - 1) / kSimtTile, G, B);
  conv_pos_simt<E, kW><<<grid, kSimtThreads, simt_smem<kW>(), stream>>>(
      static_cast<const E*>(h), mask, ms, static_cast<const E*>(w1),
      static_cast<const E*>(b1), static_cast<const E*>(w2),
      static_cast<const E*>(b2), static_cast<E*>(out), T, G);
  return cudaGetLastError();
}

}  // namespace

// Kernel CP. h and out (B, T, G*cg) contiguous, 16-byte aligned, bf16
// (f32 == 0) or f32 (f32 != 0); mask (mask_rows, T) bytes (nonzero: a
// kept frame) with mask_rows 1 (shared by the rows) or B, or null; w1,
// w2 (G, 31, cg, cg) tap tiles in h's dtype (weight_tiles' layout,
// swizzled for bf16 groups of 64), 16-byte aligned; b1, b2 (G*cg,) in
// h's dtype. cg is 16 or 64: bf16 groups of 64 run the wgmma body, the
// rest the SIMT body.
TT_EXPORT int tt_conv_pos(const void* h, const void* mask, int mask_rows,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int B, int T, int G,
                          int cg, int f32, cudaStream_t stream) {
  if (B < 1 || T < 1 || G < 1 || B > 65535 || G > 65535 ||
      (cg != 16 && cg != 64) ||
      (mask && mask_rows != 1 && mask_rows != B) ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(w1) % 16 ||
      reinterpret_cast<uintptr_t>(w2) % 16)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const long long ms = mask && mask_rows > 1 ? (long long)T : 0ll;
  if (f32)
    return (int)(cg == 64 ? launch_simt<float, 64>(h, m, ms, w1, b1, w2, b2,
                                                   out, B, T, G, stream)
                          : launch_simt<float, 16>(h, m, ms, w1, b1, w2, b2,
                                                   out, B, T, G, stream));
  if (cg == 16)
    return (int)launch_simt<__nv_bfloat16, 16>(h, m, ms, w1, b1, w2, b2, out,
                                               B, T, G, stream);
  static tt::KernelFacts facts;
  const cudaError_t err =
      facts.allow_smem(reinterpret_cast<const void*>(conv_pos_kernel));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, G, B);
  conv_pos_kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), m, ms,
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2),
      static_cast<__nv_bfloat16*>(out), T, G);
  return (int)cudaGetLastError();
}
