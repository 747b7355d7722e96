// Kernel B1's f32 core for sm_90a: the 3x3 stride-1 SAME conv of
// conv3x3.cuh in full f32 (FMAs, f32 sums, no TF32), for B1 (conv3x3.cu),
// its dgrad (B1 on flipped weights) and B2's f32 launches
// (ode_block_rk2.cu), every epilogue of conv3x3.cuh.
//
// Replaces the f32 instances of conv3x3_igemm_kernel, which gathered each
// tap's A tile again (an input pixel was loaded nine times a channel
// chunk), took MNIST's 65 channels by 4-byte copies of every tap, padded
// the dgrad's 65 output channels to two 64-wide N tiles, and read one
// 4-byte A value per 4 FMAs.  The served MNIST path and the JAX reference
// compute in full f32, so TF32 is not an option: the bound is 2*9*Cin*Cout
// flops a pixel over the card's 67 TFLOP/s outside the tensor cores.
//
// The GEMM is conv3x3.cuh's (M = N*H*W pixels flattened across images, N =
// Cout, K = 9*Cin as HWIO lies), cut as ops/conv3x3.py::conv3x3_f32_plan
// says; the launcher checks the plan and refuses what it cannot run:
//  * A block is BM = 32*WM output pixels x BN (64, or 72 for Cout 65..72)
//    output channels, 128 threads: warp w owns rows 32*(w % WM) .. +31 and
//    K share w / WM of WK = 4 / WM.  Lane (lm, ln) = (lane % 4, lane / 4)
//    holds rows 4i + lm (i < 8) and columns 4ln + j, 32 + 4ln + j (j < 4),
//    and with BN 72 also column 64 + ln: 8 x 8 (x 9) f32 sums.
//  * The halo: the source pixels of a block's rows under all nine taps,
//    copied once per 32-channel chunk (one 128-byte row a pixel, padded to
//    144 bytes so that four neighbouring rows' same 16 bytes lie in four
//    bank groups) and read by every tap: output row r under
//    tap (kh, kw) reads halo row r + kh*S + kw, or a zero row where the
//    source pixel lies outside r's image (a 9-bit mask per row).  Path
//    f32_halo: S = W, the contiguous pixels m0-W-1 .. m0+BM+W.  Path
//    f32_bands (W > BM + 2): S = BM + 2, three bands of BM + 2 pixels
//    around m0 - W, m0 and m0 + W, so a wide image's halo stays small.
//    Halos of successive chunks take turns in two buffers.
//  * K runs chunk by chunk, the nine taps of a chunk one step each (32
//    weight rows x BN in a ring of 2-4 slots); channels past the last whole
//    chunk, at most 4 (MNIST's 65th), are one more step holding all nine
//    taps' rows, so no chunk is spent on one channel.  16-byte cp.async
//    where the rows allow it (x: Cin % 4 == 0; w: a row stride of whole 16
//    bytes: the dgrad pads its flipped weights' 65 columns to 68), else
//    4-byte cp.async: MNIST's forward's Cin 65 rows are 260 bytes, so its
//    halo goes by elements, once a chunk, not once a tap.
//  * A fragment is read as float4 along K (four channels of one halo row),
//    B as float4 along N: 16 16-byte shared loads a slab of 4 channels
//    feed 256 FMAs, and the warp's loads are 4 rows and 8 column chunks,
//    one wavefront each; a slab's offsets are immediates.
//  * WK > 1 (small M, where 64 sums a thread leave under a warp an SM
//    sub-partition): share wk takes slabs wk, wk + WK, ... of every step,
//    and with BN 64 three blocks fit an SM (at most 168 registers a
//    thread); the shares' sums meet in shared memory and are added in
//    share order before the epilogue, so a block's bits never depend on
//    timing.
//  * The per-step work outside the FMAs is kept small: the halo rows'
//    pixels are divided out once a block into a table, the rows' tap masks
//    walk 4 pixels a row without dividing, and a step's weight copies are
//    a fixed count a thread.
// Members (grid z, to_member) run exactly a single launch's blocks.
#pragma once

#include "conv3x3.cuh"

namespace nodems {

constexpr int kF32Threads = 128;
constexpr int kF32Chunk = 32;    // channels of a halo row
constexpr int kF32HRow = kRowBytes + 16;  // a halo row's bytes, padded so
                                 // that 4 neighbouring rows' same 16 bytes
                                 // lie in 4 different banks
constexpr int kF32MaxTail = 4;   // channels past the whole chunks, one step
constexpr int kF32SlotRows = 9 * kF32MaxTail;  // B rows a ring slot (>= 32)

// The launch plan (ops/conv3x3.py::ConvF32Plan), as the wrappers pass it.
struct F32Plan {
  int path;    // ConvPath: kPathF32Halo or kPathF32Bands
  int rows;    // BM: 32, 64 or 128
  int cols;    // BN: 64 or 72
  int ksplit;  // WK = 128 / BM
  int stages;  // ring slots, 2 to 4
};

// What the kernel reads of the plan and the shapes.
struct F32Geom {
  int S;       // band stride of the halo
  int R;       // halo rows: BM + 2 + 2S
  int nmain;   // K chunks of up to 32 channels, a tap a step
  int tail;    // channels after them (<= 4), one step of nine taps, or 0
  int stages;
  int va, vb;  // 16-byte copies of x, of w
};

// the bytes of a ring slot: one step's weight rows
template <int BN>
__host__ __device__ constexpr int f32_slot_bytes() {
  return kF32SlotRows * BN * 4;
}

// blocks an SM: three for the 64-column K-split tiles (168 registers a
// thread), else two (the 72-column ones need more than 168)
template <int BN, int WM>
__host__ __device__ constexpr int f32_blocks_per_sm() {
  return WM < 4 && BN == 64 ? 3 : 2;
}

template <int BN, int WM, int EPI>
__global__ void __launch_bounds__(kF32Threads, f32_blocks_per_sm<BN, WM>())
conv3x3_f32_kernel(ConvArgs p, F32Geom g) {
  constexpr int BM = 32 * WM, WK = 4 / WM;
  constexpr int kSlot = f32_slot_bytes<BN>();
  constexpr int kBRow = BN * 4;  // bytes of a B row
  constexpr int kCRow = BN + 4;  // floats of a staged C row
  constexpr bool kX = BN > 64;   // the ninth column a lane

  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int nbuf = g.nmain + (g.tail > 0) > 1 ? 2 : 1;
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_halo = s_ring + g.stages * kSlot;
  const uint32_t s_zero = s_halo + nbuf * g.R * kF32HRow;

  to_member<float>(p);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int ldw = p.ldw ? p.ldw : p.Cout;  // w's row stride
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM, wk = warp / WM;
  const int lm = lane & 3, ln = lane >> 2;
  const int HW = p.H * p.W;
  const int M = p.N * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nsteps = 9 * g.nmain + (g.tail > 0 ? 1 : 0);

  if (tid < kRowBytes / 16)
    reinterpret_cast<uint4*>(smem + (s_zero - s_ring))[tid] =
        make_uint4(0, 0, 0, 0);
  // halo row q's pixel m0 + (q / S - 1) W - 1 + q % S, or -1 outside the
  // member's images: the same for every chunk, so divided out once
  int* s_hpix = reinterpret_cast<int*>(smem + (s_zero - s_ring) + kRowBytes);
  for (int q = tid; q < g.R; q += kF32Threads) {
    const int pix = m0 + (q / g.S - 1) * p.W - 1 + q % g.S;
    s_hpix[q] = pix >= 0 && pix < M ? pix : -1;
  }

  // rows wm*32 + 4i + lm: bit t of valid[i] says tap t's source pixel lies
  // inside the row's image; (oh, ow) walks 4 pixels a row
  unsigned valid[8];
  {
    const int m = m0 + wm * 32 + lm;
    const int rem = m % HW;
    int oh = rem / p.W, ow = rem - (rem / p.W) * p.W;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i > 0) {
        ow += 4;
        while (ow >= p.W) {
          ow -= p.W;
          if (++oh == p.H) oh = 0;
        }
      }
      const unsigned r = (oh > 0 ? 1u : 0u) | 2u | (oh < p.H - 1 ? 4u : 0u);
      const unsigned c = (ow > 0 ? 1u : 0u) | 2u | (ow < p.W - 1 ? 4u : 0u);
      valid[i] = m + 4 * i < M ? (r & 1u ? c : 0u) | (r & 2u ? c << 3 : 0u) |
                                     (r & 4u ? c << 6 : 0u)
                               : 0u;
    }
  }
  __syncthreads();  // the pixel table

  // step s: chunk s / 9, tap s % 9; the tail step is chunk nmain, all taps;
  // its weights go to ring slot `slot`
  auto load_stage = [&](int s, int slot) {
    const uint32_t sB = s_ring + slot * kSlot;
    const bool tail = s >= 9 * g.nmain;
    const int chunk = tail ? g.nmain : s / 9;
    const int tap = tail ? 0 : s - chunk * 9;
    const int c0 = chunk * kF32Chunk;
    const int cw = tail ? g.tail : min(kF32Chunk, p.Cin - c0);
    const int nsl = (cw + 3) >> 2;  // slabs of 4 channels
    if (tap == 0) {
      // the chunk's halo; channels past cw in the last slab are zeros
      const uint32_t h = s_halo + (chunk % nbuf) * g.R * kF32HRow;
      if (g.va) {
        const int sl = tid & 7;
        for (int q = tid >> 3; q < g.R && sl < nsl; q += kF32Threads / 8) {
          const int pix = s_hpix[q];
          const float* src =
              pix >= 0 ? x + static_cast<size_t>(pix) * p.Cin + c0 + sl * 4
                       : x;
          cp_async16(h + q * kF32HRow + sl * 16, src, pix >= 0);
        }
      } else if (lane < nsl * 4) {
        for (int q = warp; q < g.R; q += kF32Threads / 32) {
          const int pix = s_hpix[q];
          const bool ok = pix >= 0 && lane < cw;
          const float* src =
              ok ? x + static_cast<size_t>(pix) * p.Cin + c0 + lane : x;
          cp_async4(h + q * kF32HRow + lane * 4, src, ok);
        }
      }
    }
    // B row j: weight row tap*Cin + c0 + j (tail: (j/4)*Cin + c0 + j%4),
    // zeros past cw and past Cout
    constexpr int kChunks = BN / 4;
    if (!tail) {
      const float* wt =
          w + (static_cast<size_t>(tap) * p.Cin + c0) * ldw + n0;
      if (g.vb) {
        constexpr int kCopies = kF32Chunk * kChunks;
#pragma unroll
        for (int k = 0; k < (kCopies + kF32Threads - 1) / kF32Threads; ++k) {
          const int i = tid + k * kF32Threads;
          if (kCopies % kF32Threads != 0 && i >= kCopies) break;
          const int j = i / kChunks, ch = i - j * kChunks;
          const bool ok = j < cw && n0 + ch * 4 < p.Cout;
          cp_async16(sB + j * kBRow + ch * 16, ok ? wt + j * ldw + ch * 4 : w,
                     ok);
        }
      } else {
        static_assert(kF32Chunk * BN % kF32Threads == 0, "whole rounds");
#pragma unroll
        for (int k = 0; k < kF32Chunk * BN / kF32Threads; ++k) {
          const int i = tid + k * kF32Threads;
          const int j = i / BN, c = i - j * BN;
          const bool ok = j < cw && n0 + c < p.Cout;
          cp_async4(sB + j * kBRow + c * 4, ok ? wt + j * ldw + c : w, ok);
        }
      }
    } else {
      const float* wt = w + static_cast<size_t>(c0) * ldw + n0;
      const int per = g.vb ? kChunks : BN;  // copies a B row
      for (int i = tid; i < kF32SlotRows * per; i += kF32Threads) {
        const int j = i / per, e = i - j * per;
        const int c = g.vb ? e * 4 : e;
        const bool ok = (j & 3) < cw && n0 + c < p.Cout;
        const float* src =
            ok ? wt + ((j >> 2) * p.Cin + (j & 3)) * ldw + c : w;
        if (g.vb)
          cp_async16(sB + j * kBRow + c * 4, src, ok);
        else
          cp_async4(sB + j * kBRow + c * 4, src, ok);
      }
    }
  };

  float acc[8][8];
  float accx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    accx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // one slab: 4 channels of the rows at arow[i] + aoff, B rows brow ..
  // brow + 3 (this lane's columns at ln*16, 128 + ln*16, 256 + ln*4)
  auto slab = [&](const uint32_t (&arow)[8], int aoff, uint32_t brow) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = lds128(arow[i] + aoff);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t br = brow + kk * kBRow;
      const float4 b0 = lds128(br + ln * 16);
      const float4 b1 = lds128(br + 128 + ln * 16);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float bx = 0.0f;
      if constexpr (kX) bx = lds32(br + 256 + ln * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0 ? a[i].x
                         : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z
                                   : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        if constexpr (kX) accx[i] = fmaf(av, bx, accx[i]);
      }
    }
  };

  // the halo rows of tap t in buffer h, plus `off` bytes (the zero row
  // where the source pixel lies outside the image)
  auto tap_rows = [&](uint32_t h, int t, int off, uint32_t (&arow)[8]) {
    const int qoff = (t / 3) * g.S + t % 3;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = wm * 32 + 4 * i + lm + qoff;
      arow[i] = ((valid[i] >> t) & 1u ? h + q * kF32HRow : s_zero) + off;
    }
  };

  // step s: share wk's slabs wk, wk + WK, ... of a tap, or its taps wk,
  // wk + WK, ... of the tail
  auto compute = [&](int s) {
    const bool tail = s >= 9 * g.nmain;
    const int chunk = tail ? g.nmain : s / 9;
    const uint32_t h = s_halo + (chunk % nbuf) * g.R * kF32HRow;
    const uint32_t sB = s_ring + (s % g.stages) * kSlot;
    uint32_t arow[8];
    if (!tail) {
      const int cw = min(kF32Chunk, p.Cin - chunk * kF32Chunk);
      tap_rows(h, s - chunk * 9, wk * 16, arow);
      const uint32_t bw = sB + wk * 4 * kBRow;
      if (cw == kF32Chunk) {
#pragma unroll
        for (int j = 0; j < 8 / WK; ++j)
          slab(arow, j * WK * 16, bw + j * WK * 4 * kBRow);
      } else {
        for (int j = 0; wk + j * WK < (cw + 3) >> 2; ++j)
          slab(arow, j * WK * 16, bw + j * WK * 4 * kBRow);
      }
    } else {
      for (int t = wk; t < 9; t += WK) {
        tap_rows(h, t, 0, arow);
        slab(arow, 0, sB + t * 4 * kBRow);
      }
    }
  };

  const int PD = g.stages - 1;  // steps loaded ahead
  for (int s = 0; s < PD; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_upto(PD - 1);
    // step s has landed for every thread; the slot refilled below was last
    // read by step s - 1, and the halo buffer by a chunk two back, both
    // finished by every thread
    __syncthreads();
    if (s + PD < nsteps) load_stage(s + PD, (s + PD) % g.stages);
    cp_async_commit();
    compute(s);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring and the halos

  // K share wk's sums to its tile, then each element's shares in order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + (wk * BM + wm * 32 + 4 * i + lm) * kCRow;
    *reinterpret_cast<float4*>(row + 4 * ln) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * ln) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    if constexpr (kX) row[64 + ln] = accx[i];
  }
  __syncthreads();
  constexpr int kChunksRow = BN / 8;
  for (int i = tid; i < BM * kChunksRow; i += kF32Threads) {
    const int r = i / kChunksRow;
    const int c = (i - r * kChunksRow) * 8;
    if (m0 + r >= M || n0 + c >= p.Cout) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = part[r * kCRow + c + e];
#pragma unroll
    for (int k = 1; k < WK; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += part[(k * BM + r) * kCRow + c + e];
    epilogue_chunk<float, EPI>(p, m0 + r, n0 + c, v);
  }
}

// Checks an f32 plan against the shapes and the device's opt-in shared
// memory; fills the kernel's geometry and its dynamic shared memory.
// Returns the plan's path, or -1 for a plan the kernel cannot run.
inline int f32_plan_geom(const ConvArgs& p, const F32Plan& pl, int optin,
                         F32Geom* g, long long* smem) {
  if ((pl.rows != 32 && pl.rows != 64 && pl.rows != 128) ||
      (p.ldw != 0 && p.ldw < p.Cout) ||
      pl.ksplit * pl.rows != kF32Threads ||
      (pl.cols != 64 && pl.cols != 72) || pl.stages < 2 || pl.stages > 4)
    return -1;
  const int bands = pl.rows + 2;
  const int path = p.W <= bands ? kPathF32Halo : kPathF32Bands;
  if (pl.path != path) return -1;
  g->S = p.W <= bands ? p.W : bands;
  g->R = pl.rows + 2 + 2 * g->S;
  const int rem = p.Cin % kF32Chunk;
  g->tail = rem <= kF32MaxTail ? rem : 0;
  g->nmain = (p.Cin - g->tail + kF32Chunk - 1) / kF32Chunk;
  g->stages = pl.stages;
  const long long nbuf = g->nmain + (g->tail > 0) > 1 ? 2 : 1;
  const long long ring =
      static_cast<long long>(pl.stages) * kF32SlotRows * pl.cols * 4 +
      nbuf * g->R * kF32HRow + kRowBytes + 4LL * g->R;
  const long long part =
      static_cast<long long>(pl.ksplit) * pl.rows * (pl.cols + 4) * 4;
  *smem = 128 + (ring > part ? ring : part);
  if (*smem > optin) return -1;
  // the member's pixel offsets and weight rows stay within int
  if (static_cast<long long>(p.N) * p.H * p.W + g->R + 2LL * p.W >=
      (1LL << 31))
    return -1;
  return path;
}

template <int BN, int WM, int EPI>
cudaError_t launch_f32_tile(const ConvArgs& p, const F32Geom& g,
                            long long smem, int device, int optin,
                            cudaStream_t stream) {
  auto kernel = conv3x3_f32_kernel<BN, WM, EPI>;
  // the whole opt-in size once per device, on the first launch (which
  // callers make outside any CUDA-graph capture): the halo depends on W
  static std::atomic<bool> opted[kMaxDevices];
  if (!opted[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const long long M = static_cast<long long>(p.N) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((M + 32 * WM - 1) / (32 * WM)),
                  static_cast<unsigned>((p.Cout + BN - 1) / BN),
                  static_cast<unsigned>(p.S));
  kernel<<<grid, kF32Threads, static_cast<size_t>(smem), stream>>>(p, g);
  return cudaGetLastError();
}

template <int BN, int EPI>
cudaError_t launch_f32_cols(const ConvArgs& p, const F32Plan& pl,
                            const F32Geom& g, long long smem, int device,
                            int optin, cudaStream_t st) {
  switch (pl.rows) {
    case 128:
      return launch_f32_tile<BN, 4, EPI>(p, g, smem, device, optin, st);
    case 64:
      return launch_f32_tile<BN, 2, EPI>(p, g, smem, device, optin, st);
    default:
      return launch_f32_tile<BN, 1, EPI>(p, g, smem, device, optin, st);
  }
}

// The f32 conv under plan `pl`, or cudaErrorInvalidValue for a plan the
// shapes or the device's shared memory refuse.
template <int EPI>
cudaError_t launch_conv3x3_f32(const ConvArgs& p, const F32Plan& pl,
                               int device, void* stream) {
  int optin = 0;
  cudaError_t err = conv3x3_prepare(p, device, &optin);
  if (err != cudaSuccess) return err;
  F32Geom g{};
  long long smem = 0;
  if (f32_plan_geom(p, pl, optin, &g, &smem) < 0) return cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(p.w);
  g.va = p.Cin % 4 == 0 && (xa & 15) == 0;
  g.vb = (p.ldw ? p.ldw : p.Cout) % 4 == 0 && (wa & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.cols == 72)
    return launch_f32_cols<72, EPI>(p, pl, g, smem, device, optin, st);
  return launch_f32_cols<64, EPI>(p, pl, g, smem, device, optin, st);
}

}  // namespace nodems
