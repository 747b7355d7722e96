// Kernel B1's weight gradient (wgrad) for sm_90a:
//   dW[kh, kw, ci, co] = sum over pixels (n, h, w) of
//                        x[n, h+kh-1, w+kw-1, ci] * dy[n, h, w, co],
// zero-padded (SAME), x (N, H, W, Cin) and dy (N, H, W, Cout) NHWC, dW
// (3, 3, Cin, Cout) HWIO, T float or __nv_bfloat16, sums in f32 and the
// result rounded once to T.
//
// Not a TPU kernel: the Pallas B1 (neural_ode_metasolver_tpu/ops/
// pallas_im2col.py:93) has no VJP and JAX differentiates XLA's conv.  The
// port routes every stride-1 3x3 conv through B1, so training needs B1's
// backward; its dgrad is B1 itself on flipped weights (ops/conv3x3.py).
//
// The GEMM: M = 9*Cin rows (tap, channel), N = Cout, and a long K =
// N*H*W pixels (262,144 at batch 256, 32x32; 65,536 at 16x16).  Bound on
// the H100: 2*9*Cin*Cout flops per pixel against 2*(Cin + Cout) bytes in
// bf16, 19.3 GFLOP and 67 MB at (256,32,32,64->64): about 0.020 ms, near
// the ridge.
//
// Both paths split K into S contiguous ranges (ops/conv3x3.py::wgrad_plan
// picks the path, S and the step from the shapes, the type and the SM
// count; the entry point checks the plan).  A block sums its range in f32
// registers and writes its partial (9, Cin, Cout) tile to a workspace (on
// the TMA path, one partial per cluster of ranges); a second launch adds
// each element's partials in range order and rounds once.  No float
// atomics, so a launch repeats its bits.
//
// The TMA path (bf16; Cin, Cout multiples of 8 and W of 8: the flagship's
// 64->64 and 128->128):
//  * A K step is `rows` whole image rows of one image (rows*W pixels, 4 to
//    8 k16 slices: a template instance each).  For each kw the producer warp loads one TMA box of
//    x, (rows+2) image rows x W pixels x 64 channels at (h0-1, kw-1, c0),
//    through a 4-D tensor map over (N, H, W, C): TMA writes zeros for the
//    coordinates outside the image, which is the SAME padding at every
//    edge, and for the channels past Cin.  One box of dy (rows x W x 64 at
//    (h0, 0, n0)) serves all nine taps.
//  * Tap (kh, kw) is box kw read from pixel row kh*W on.  A pixel row is
//    128 bytes, so with W % 8 == 0 that is a whole number of the 1024-byte
//    atoms of the 128-byte swizzle TMA writes: each tap's wgmma descriptor
//    starts on an atom.
//  * x and dy lie pixel-major, channels contiguous: A (co x pixels, from
//    dy) and B (pixels x ci, from x) are both MN-major, which bf16 wgmma
//    reads from shared memory with both transpose bits set.
//  * Three consumer warpgroups, warpgroup kh owning taps (kh, 0..2) as one
//    product: m64n192k16 per 16 pixels, B's three 64-channel panels being
//    the three x boxes (the panel stride is the box's size), so dy is read
//    from shared memory once for the three taps; 96 f32 sums a thread.
//    The producer warp keeps a ring of 2-4 steps in flight, each guarded
//    by a full (TMA transaction bytes) and an empty (consumer warps)
//    mbarrier.  Its warpgroup hands its registers to the consumers
//    (setmaxnreg), which hold 96 sums each without spilling.
//  * Clusters of consecutive splits: each block stages its sums in shared
//    memory and the cluster adds them in rank order through distributed
//    shared memory before one partial is written.
//
// The split-K path (bf16 shapes the TMA path does not take: the stem's Cin
// 3, MNIST's 65, W % 8 != 0, rows of more than 8 k16 slices):
//  * A block owns one 128-byte chunk of Cin (64 channels), one of Cout,
//    and all nine taps: warp t computes tap t.  Each K step copies into
//    shared memory, once, the x halo the step's nine taps read (pixels
//    k0-W-1 .. k0+BK+W, the forward halo kernel's trick) and the step's dy
//    rows.  Tap (kh, kw) reads the halo shifted by kh*W + kw rows, or a
//    zero row where the source pixel lies outside its image (a 9-bit mask
//    per pixel, written when the step is copied).
//  * mma.sync m16n8k16 on the tensor cores.  x and dy lie pixel-major
//    (K-major for this GEMM), so ldmatrix.trans gathers both operands, one
//    row address per lane (which is how the padding's zero row gets in); a
//    warp holds its tap's 64 x 64 tile, 128 sums a thread.
//  * A ring of 3 K steps filled by 16-byte cp.async where the channel count
//    and the pointer allow, else by element copies into a ring zeroed once.
//
// The f32 path (every f32 shape; full-f32 FMAs, no TF32, as the JAX
// reference computes): the split-K path's halo, masks and ranges, cut for
// FMAs.
//  * x and dy lie pixel-major: for one pixel, a row of channels.  In this
//    GEMM (M = Cin, N = Cout, K = pixels) that is both operands M- and
//    N-contiguous, the layout of an FMA GEMM: a lane reads its 8 Cin sums'
//    x values as two float4 from one halo row and its 4 Cout sums' dy
//    values as one from one dy row, 3 16-byte loads for 32 FMAs.
//  * A block owns 32 channels of Cin, 32 of Cout and all nine taps: warp t
//    sums tap t's 32 x 32 tile, 8 x 4 sums a lane (lane (lm, ln) = (lane %
//    4, lane / 4): Cin 4lm + i, 16 + 4lm + i; Cout 4ln + j), so two blocks
//    of nine warps fit an SM (96 registers a thread); with 8 x 8 sums a
//    lane one block did, and the digits wgrad ran 20% slower.
//  * Channels past the last whole 32 (at most 4: MNIST's 65th) take no
//    block of their own: they sit in the 16 bytes that pad each halo row of
//    the last Cin block to 144 (the padding also keeps four neighbouring
//    rows' loads in four bank groups), and each tap warp sums them with
//    the dy values it already holds: 8 more FMAs a channel and pixel.
//  * A tap's source pixel outside the image reads a zero row (a ballot of
//    the step's 64 pixels a warp gives the mask): no branch in the loop.
//  * K steps of 64 pixels; halo and dy rows by 16-byte cp.async where the
//    channel count and the pointer allow (MNIST's Cin 65 rows are 260
//    bytes: its halo takes 4-byte copies, once a step, not once a tap).
//  * The K ranges (ops/conv3x3.py::wgrad_plan) keep three steps or more
//    each, so the partials the reduce reads stay few beside the work.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the driver's enums; no -lcuda needed

#include "conv3x3.cuh"

namespace nodems {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 9;  // one per tap
constexpr int kWThreads = 32 * kWarps;
constexpr int kStages = 3;

// pixels per K step of the bf16 split-K path (ops/conv3x3.py::WGRAD_BK)
constexpr int kWgradBK = 128;

struct WgradArgs {
  const void* x;   // (S, N, H, W, Cin)
  const void* dy;  // (S, N, H, W, Cout)
  float* ws;       // (S, splits, 9, Cin, Cout) partial sums
  int N, H, W, Cin, Cout;  // N images a member
  int splits, steps, halo_rows;  // a member's
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b, one m16n8k16 tile, bf16 in, f32 accumulate.  a: A (16 x 16,
// row-major) in the m16n8k16 fragment order; b0, b1: B (16 x 8) columns.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the bytes of one ring slot: halo rows, dy rows, the pixels' tap masks
template <int BK>
__host__ __device__ __forceinline__ int slot_bytes(int halo_rows) {
  return (halo_rows + BK) * kRowBytes + (BK * 2 + kRowBytes - 1) /
                                            kRowBytes * kRowBytes;
}

// The bf16 split-K path.  C (9-tap tile) of one block: blockIdx = (Cin
// chunk, Cout chunk, member * splits + split).  A member-batched launch (S members, each N images of
// its own) runs each member's splits over its own images only, exactly as
// a single launch on that member runs them, into the member's own
// workspace rows; a single run is member 0.  VX / VDY: 16-byte copies of x / dy (channels a multiple of 16 bytes and
// the pointer aligned), else element copies.
template <bool VX, bool VDY>
__global__ void __launch_bounds__(kWThreads, 1)
wgrad_partial_kernel(WgradArgs p) {
  using T = __nv_bfloat16;
  constexpr int BK = kWgradBK;
  constexpr int CH = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int PD = kStages - 1;  // steps loaded ahead
  constexpr int kDyBytes = BK * kRowBytes;

  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int R = p.halo_rows;
  const int halo_bytes = R * kRowBytes;
  const int slot = slot_bytes<BK>(R);
  char* s_zero = smem + kStages * slot;  // one row of zeros

  const int member = static_cast<int>(blockIdx.z) / p.splits;
  const int split = static_cast<int>(blockIdx.z) - member * p.splits;
  const int HW = p.H * p.W;
  const int P = p.N * HW;
  const T* x = static_cast<const T*>(p.x) +
               static_cast<size_t>(member) * P * p.Cin;
  const T* dy = static_cast<const T*>(p.dy) +
                static_cast<size_t>(member) * P * p.Cout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap = tid >> 5;
  const int c0 = blockIdx.x * CH;
  const int n0 = blockIdx.y * CH;
  const int g0 = static_cast<int>(static_cast<long long>(p.steps) * split /
                                  p.splits);
  const int g1 = static_cast<int>(static_cast<long long>(p.steps) *
                                  (split + 1) / p.splits);
  const int nsteps = g1 - g0;
  const int cw = min(CH, p.Cin - c0);   // channels of the chunks that exist
  const int nw = min(CH, p.Cout - n0);

  // element copies write only the channels that exist: zero the ring once
  if (!VX || !VDY) {
    const int n16 = (kStages * slot + kRowBytes) / 16;
    for (int i = tid; i < n16; i += kWThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  } else if (tid < kRowBytes / 16) {
    reinterpret_cast<uint4*>(s_zero)[tid] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  auto load_stage = [&](int g, int sl) {
    char* sh = smem + sl * slot;
    char* sd = sh + halo_bytes;
    uint16_t* sm = reinterpret_cast<uint16_t*>(sd + kDyBytes);
    const int k0 = g * BK;
    const int q0 = k0 - p.W - 1;  // the pixel of halo row 0
    if constexpr (VX) {
      for (int i = tid; i < R * 8; i += kWThreads) {
        const int q = i >> 3, ch = i & 7;
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < P && ch * E < cw;
        const T* src =
            ok ? x + static_cast<size_t>(pix) * p.Cin + c0 + ch * E : x;
        cp_async16(smem_u32(sh + swz(q, ch, kRowBytes)), src, ok);
      }
    } else {
      for (int i = tid; i < R * cw; i += kWThreads) {
        const int q = i / cw, c = i - q * cw;
        const int pix = q0 + q;
        T v = from_f32<T>(0.0f);
        if (pix >= 0 && pix < P) v = x[static_cast<size_t>(pix) * p.Cin + c0 + c];
        *reinterpret_cast<T*>(sh + swz(q, c / E, kRowBytes) +
                              (c % E) * static_cast<int>(sizeof(T))) = v;
      }
    }
    if constexpr (VDY) {
      for (int i = tid; i < BK * 8; i += kWThreads) {
        const int r = i >> 3, ch = i & 7;
        const int pix = k0 + r;
        const bool ok = pix < P && ch * E < nw;
        const T* src =
            ok ? dy + static_cast<size_t>(pix) * p.Cout + n0 + ch * E : dy;
        cp_async16(smem_u32(sd + swz(r, ch, kRowBytes)), src, ok);
      }
    } else {
      for (int i = tid; i < BK * nw; i += kWThreads) {
        const int r = i / nw, c = i - r * nw;
        const int pix = k0 + r;
        T v = from_f32<T>(0.0f);
        if (pix < P) v = dy[static_cast<size_t>(pix) * p.Cout + n0 + c];
        *reinterpret_cast<T*>(sd + swz(r, c / E, kRowBytes) +
                              (c % E) * static_cast<int>(sizeof(T))) = v;
      }
    }
    // bit t: tap t's source pixel of output pixel k0 + r lies in its image
    for (int r = tid; r < BK; r += kWThreads) {
      const int pix = k0 + r;
      unsigned m = 0;
      if (pix < P) {
        const int rem = pix % HW;
        const int h = rem / p.W, w = rem - (rem / p.W) * p.W;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int ih = h + t / 3 - 1, iw = w + t % 3 - 1;
          if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) m |= 1u << t;
        }
      }
      sm[r] = static_cast<uint16_t>(m);
    }
  };

  // acc[(mi * 8 + nj) * 4 + i], the m16n8 tile (mi, nj) of the warp's
  // 64 x 64
  constexpr int kAcc = 128;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int toff = (tap / 3) * p.W + tap % 3;  // halo row of pixel row 0

  auto compute = [&](int sl) {
    const char* sh = smem + sl * slot;
    const char* sd = sh + halo_bytes;
    const uint16_t* sm = reinterpret_cast<const uint16_t*>(sd + kDyBytes);
    // ldmatrix.trans lane rows: A (x) matrices are (k 0-7, m 0-7), (k 0-7,
    // m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15); B (dy) matrices (k 0-7,
    // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
    const int a_r = (lane & 7) + ((lane >> 4) << 3);
    const int a_c = (lane >> 3) & 1;
    const int b_r = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int b_c = lane >> 4;
#pragma unroll 2
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int r = kk * 16 + a_r;
      const bool ok = (sm[r] >> tap) & 1u;
      const int hr = r + toff;
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int ch = 2 * mi + a_c;
        ldmatrix_x4_trans(a[mi], smem_u32(ok ? sh + swz(hr, ch, kRowBytes)
                                             : s_zero + ch * 16));
      }
      const int br = kk * 16 + b_r;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
        ldmatrix_x4_trans(b[jp],
                          smem_u32(sd + swz(br, 2 * jp + b_c, kRowBytes)));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          mma_bf16(acc + (mi * 8 + nj) * 4, a[mi], b[nj >> 1][(nj & 1) * 2],
                   b[nj >> 1][(nj & 1) * 2 + 1]);
    }
  };

#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (s < nsteps) load_stage(g0 + s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<PD - 1>();
    // step kt has landed for every thread; the slot refilled below was
    // last read by step kt - 1, which every warp has finished
    __syncthreads();
    const int next = kt + PD;
    if (next < nsteps) load_stage(g0 + next, next % kStages);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();

  float* ws = p.ws + (static_cast<size_t>(blockIdx.z) * 9 + tap) *
                         static_cast<size_t>(p.Cin) * p.Cout;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = c0 + mi * 16 + g + 8 * (i >> 1);
        const int co = n0 + nj * 8 + 2 * t4 + (i & 1);
        if (ci < p.Cin && co < p.Cout)
          ws[static_cast<size_t>(ci) * p.Cout + co] =
              acc[(mi * 8 + nj) * 4 + i];
      }
}

// out[m][i] = T(sum over k in order of ws[m][k][i]), member m = blockIdx.y
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t m = blockIdx.y;
  ws += m * splits * static_cast<size_t>(n);
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[static_cast<size_t>(k) * n + i];
  out[m * n + i] = from_f32<T>(s);
}

template <bool VX, bool VDY>
cudaError_t launch_partials(const WgradArgs& p, int S, int device,
                            cudaStream_t st) {
  constexpr int BK = kWgradBK;
  constexpr int CH = kRowBytes / 2;
  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;
  const long long bytes =
      128LL + kStages * static_cast<long long>(slot_bytes<BK>(p.halo_rows)) +
      kRowBytes;
  if (bytes > optin) return cudaErrorInvalidValue;  // images too wide
  auto kernel = wgrad_partial_kernel<VX, VDY>;
  // the whole opt-in size once per device, on the first launch (which
  // callers make outside any CUDA-graph capture): the halo depends on W
  static std::atomic<bool> opted[kMaxDevices];
  if (!opted[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((p.Cin + CH - 1) / CH, (p.Cout + CH - 1) / CH,
                  S * p.splits);
  kernel<<<grid, kWThreads, static_cast<size_t>(bytes), st>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------- TMA path

constexpr int kTmaConsumers = 3;  // warpgroups, one per kh
constexpr int kTmaProducer = 4 * kTmaConsumers;  // the producer's warp
constexpr int kTmaConsumerThreads = 128 * kTmaConsumers;
constexpr int kTmaThreads = kTmaConsumerThreads + 128;  // + a producer group
// registers a thread once the roles split (setmaxnreg): the producer
// warpgroup gives its own up, the consumers take them; 128 * 40 + 384 *
// 152 fits the SM's 65,536
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
constexpr int kTmaMaxStages = 4;
constexpr int kTmaChannels = 64;  // of Cin and of Cout per block: 128 B

struct TmaWgradArgs {
  float* ws;            // (splits, 9, Cin, Cout) partial sums
  int Cin, Cout, W;
  int rows;             // image rows per K step
  int steps_per_image;  // ceil(H / rows)
  int steps;            // N * steps_per_image
  int splits, stages;
  int cluster;          // consecutive splits summed in shared memory
};

// One TMA box of a 4-D tensor map at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory; completes transaction bytes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// d += A * B, m64n192k16, bf16 in, f32 accumulate, A and B both MN-major
// in shared memory (imm-trans-a 1, imm-trans-b 1): A is dy (64 Cout rows),
// B the three x boxes as three 64-channel panels LBO apart.  Thread t of
// the warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and, for each n8
// block j, columns 8j + 2*(t%4) (+1): d[4j], d[4j+1], then row + 8.
__device__ __forceinline__ void wgmma_tt192(float (&d)[96], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// bytes of one x box and of one dy box of a K step
__host__ __device__ __forceinline__ int tma_x_box(int rows, int W) {
  return (rows + 2) * W * kRowBytes;
}
__host__ __device__ __forceinline__ int tma_dy_box(int rows, int W) {
  return rows * W * kRowBytes;
}

// The f32 sums of a block's 9 x 64 x 64 tile staged in shared memory for
// the cluster's sum, rows padded to kTileRow floats
constexpr int kTileRow = kTmaChannels + 4;
constexpr int kTileBytes = 9 * kTmaChannels * kTileRow * 4;

// blockIdx = (Cin chunk, Cout chunk, split); KS k16 slices a K step.
// Shared memory: the ring of stages (three x boxes, then the dy box, each
// 1024-byte aligned), then the full and empty barriers; after the main
// loop, the tile of sums where the cluster sums its splits.
template <int KS>
__global__ void __launch_bounds__(kTmaThreads, 1)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_dy, TmaWgradArgs p) {
  extern __shared__ __align__(1024) char tma_smem[];
  char* smem = tma_smem + ((1024 - (smem_u32(tma_smem) & 1023)) & 1023);
  const int box_x = tma_x_box(p.rows, p.W);
  const int stage_bytes = 3 * box_x + tma_dy_box(p.rows, p.W);
  // the barriers lie past the ring and past the tile that reuses it
  const int ring = p.stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (p.cluster > 1 && kTileBytes > ring ? kTileBytes : ring));
  uint64_t* empty = full + kTmaMaxStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kTmaChannels;
  const int n0 = blockIdx.y * kTmaChannels;
  const int split = blockIdx.z;
  const int g0 = static_cast<int>(static_cast<long long>(p.steps) * split /
                                  p.splits);
  const int nsteps = static_cast<int>(static_cast<long long>(p.steps) *
                                      (split + 1) / p.splits) - g0;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 4 * kTmaConsumers);  // lane 0 a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kTmaProducer) {
    // the producer warpgroup: one thread issues the loads; with a cluster,
    // the group joins the block's and the cluster's barriers below
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kTmaProducer && lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % p.stages;
        // use i / stages of slot s waits for the consumers' release of the
        // use before it
        if (i >= p.stages) mbar_wait(smem_u32(empty + s), (i / p.stages - 1) & 1);
        const int g = g0 + i;
        const int n = g / p.steps_per_image;
        const int h0 = (g - n * p.steps_per_image) * p.rows;
        const uint32_t st = smem_u32(smem + s * stage_bytes);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, static_cast<uint32_t>(stage_bytes));
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          tma_load_4d(st + kw * box_x, &tm_x, c0, kw - 1, h0 - 1, n, bar);
        tma_load_4d(st + 3 * box_x, &tm_dy, n0, 0, h0, n, bar);
      }
    }
    if (p.cluster > 1) {
      __syncthreads();
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // consumer warpgroup kh: taps (kh, 0), (kh, 1), (kh, 2) as one
  // (Cout x 3*Cin) product, accumulator column 64*kw + ci
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int kh = warp >> 2;
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % p.stages;
    mbar_wait(smem_u32(full + s), (i / p.stages) & 1);
    const uint32_t st = smem_u32(smem + s * stage_bytes);
    const uint32_t a = st + 3 * box_x;               // dy
    const uint32_t b = st + kh * p.W * kRowBytes;    // box 0 from row kh*W
    fence_operands(acc);
    wgmma_fence();
    // MN-major operands: a k16 slice is 16 pixel rows, two 1024-byte atoms
    // (SBO); B's three 64-channel panels are the three x boxes, box_x bytes
    // apart (LBO); A is one 64-channel panel
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = kk * 16 * kRowBytes;
      wgmma_tt192(acc, sw128_desc(a + off, 8192, 1024),
                  sw128_desc(b + off, box_x, 1024));
    }
    wgmma_commit();
    // the products of step i - 1 are done: its slot may be refilled
    wgmma_wait<1>();
    fence_operands(acc);
    if (i > 0 && lane == 0)
      mbar_arrive(smem_u32(empty + (i - 1) % p.stages));
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // thread rows co = 16*(warp%4) + lane/4 (+8), columns 64*kw + ci with
  // ci = 8j + 2*(lane%4) (+1) of the block's tile: acc[4*(8kw + j) + e]
  const int co_t = 16 * (warp & 3) + (lane >> 2);
  const int ci_t = 2 * (lane & 3);
  const size_t tap_stride = static_cast<size_t>(p.Cin) * p.Cout;
  if (p.cluster == 1) {
    // this split's partial straight to the workspace
    float* ws0 = p.ws + (static_cast<size_t>(split) * 9 + kh * 3) * tap_stride;
#pragma unroll
    for (int j = 0; j < 24; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = c0 + 8 * (j & 7) + ci_t + (e & 1);
        const int co = n0 + co_t + 8 * (e >> 1);
        if (ci < p.Cin && co < p.Cout)
          ws0[(j >> 3) * tap_stride + static_cast<size_t>(ci) * p.Cout + co] =
              acc[4 * j + e];
      }
    return;
  }

  // The cluster's splits are consecutive: each block stages its tile in
  // shared memory, then block rank q sums slice q of the tile over the
  // cluster's blocks in rank order and writes the cluster's partial.
  __syncthreads();  // every wgmma has read its last slot: the ring is free
  float* tile = reinterpret_cast<float*>(smem);
  float* t = tile + kh * 3 * kTmaChannels * kTileRow;
#pragma unroll
  for (int j = 0; j < 24; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[((j >> 3) * kTmaChannels + 8 * (j & 7) + ci_t + (e & 1)) * kTileRow +
        co_t + 8 * (e >> 1)] = acc[4 * j + e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int kUnits = 9 * kTmaChannels * kTmaChannels / 4;  // float4s
  const int per = (kUnits + p.cluster - 1) / p.cluster;
  const int u1 = min(kUnits, (q + 1) * per);
  float* part = p.ws + static_cast<size_t>(split / p.cluster) * 9 * tap_stride;
  for (int u = q * per + tid; u < u1; u += kTmaConsumerThreads) {
    const int tap = u / (kTmaChannels * kTmaChannels / 4);
    const int i = (u / (kTmaChannels / 4)) % kTmaChannels;
    const int j = (u % (kTmaChannels / 4)) * 4;
    const int off = (tap * kTmaChannels + i) * kTileRow + j;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(tile, 0) + off);
    for (int k = 1; k < p.cluster; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(tile, k) + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int ci = c0 + i, co = n0 + j;
    if (ci < p.Cin && co < p.Cout)
      *reinterpret_cast<float4*>(part + tap * tap_stride +
                                 static_cast<size_t>(ci) * p.Cout + co) = sum;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no -lcuda).
cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::atomic<void*> cached{nullptr};
  void* f = cached.load(std::memory_order_acquire);
  if (f == nullptr) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || f == nullptr)
      return cudaErrorSymbolNotFound;
    cached.store(f, std::memory_order_release);
  }
  *fn = reinterpret_cast<EncodeTiled>(f);
  return cudaSuccess;
}

// A bf16 tensor map over (N, H, W, C), C innermost, whose box is 64
// channels x W x box_rows x 1 in the 128-byte swizzle; coordinates outside
// the tensor read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int N, int H, int W,
                     int C, int box_rows) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kTmaChannels),
                             static_cast<cuuint32_t>(W),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dynamic shared memory of the TMA path: alignment slack, the ring (or
// the staged tile where a cluster sums its splits and that is larger),
// then the barriers
long long tma_smem_bytes(int rows, int W, int stages, int cluster) {
  const long long ring =
      stages * (3LL * tma_x_box(rows, W) + tma_dy_box(rows, W));
  return 1024LL + (cluster > 1 && kTileBytes > ring ? kTileBytes : ring) +
         2LL * kTmaMaxStages * sizeof(uint64_t);
}

template <int KS>
cudaError_t launch_tma_ks(const CUtensorMap& mx, const CUtensorMap& mdy,
                          const TmaWgradArgs& p, dim3 grid, long long bytes,
                          int device, int optin, cudaStream_t st) {
  auto kernel = wgrad_tma_kernel<KS>;
  static std::atomic<bool> opted[kMaxDevices];
  if (!opted[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  if (p.cluster == 1) {
    kernel<<<grid, kTmaThreads, static_cast<size_t>(bytes), st>>>(mx, mdy, p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, mx, mdy, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K steps of 64 to 128 pixels: 4 to 8 k16 slices, each an instance
constexpr int kTmaMinSlices = 4, kTmaMaxSlices = 8;

cudaError_t launch_tma_partials(const void* x, const void* dy, float* ws,
                                int N, int H, int W, int Cin, int Cout,
                                int splits, int rows, int stages, int cluster,
                                int device, cudaStream_t st) {
  // what TMA and the descriptors need: 16-byte global strides and base
  // addresses, boxes of at most 256 per dimension, taps on whole swizzle
  // atoms, K steps of whole k16 slices; clusters of consecutive splits
  const int ks = rows * W / 16;
  if (Cin % 8 != 0 || Cout % 8 != 0 || W % 8 != 0 || W > 256 || rows < 1 ||
      rows + 2 > 256 || (rows * W) % 16 != 0 || ks < kTmaMinSlices ||
      ks > kTmaMaxSlices || stages < 2 || stages > kTmaMaxStages ||
      cluster < 1 || cluster > 8 || splits % cluster != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(dy) & 15) != 0)
    return cudaErrorInvalidValue;
  const int spi = (H + rows - 1) / rows;
  const long long steps = static_cast<long long>(N) * spi;
  if (steps >= (1LL << 31) || splits > steps) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;
  const long long bytes = tma_smem_bytes(rows, W, stages, cluster);
  if (bytes > optin) return cudaErrorInvalidValue;
  CUtensorMap mx, mdy;
  err = make_map(&mx, x, N, H, W, Cin, rows + 2);
  if (err != cudaSuccess) return err;
  err = make_map(&mdy, dy, N, H, W, Cout, rows);
  if (err != cudaSuccess) return err;
  const TmaWgradArgs p{ws, Cin, Cout, W, rows, spi,
                       static_cast<int>(steps), splits, stages, cluster};
  const dim3 grid((Cin + kTmaChannels - 1) / kTmaChannels,
                  (Cout + kTmaChannels - 1) / kTmaChannels, splits);
  switch (ks) {
    case 4: return launch_tma_ks<4>(mx, mdy, p, grid, bytes, device, optin, st);
    case 5: return launch_tma_ks<5>(mx, mdy, p, grid, bytes, device, optin, st);
    case 6: return launch_tma_ks<6>(mx, mdy, p, grid, bytes, device, optin, st);
    case 7: return launch_tma_ks<7>(mx, mdy, p, grid, bytes, device, optin, st);
    default: return launch_tma_ks<8>(mx, mdy, p, grid, bytes, device, optin, st);
  }
}

// ------------------------------------------------------------- f32 path

constexpr int kF32TapWarps = 9;
constexpr int kF32WThreads = 32 * kF32TapWarps;
constexpr int kF32Ci = 32;        // Cin channels of a block
constexpr int kF32Co = 32;        // Cout channels of a block
constexpr int kF32MaxFold = 4;    // channels past the last whole 32 folded
constexpr int kF32BK = 64;        // pixels a K step (ops/conv3x3.py)
constexpr int kF32XRow = kRowBytes + 16;  // a halo row: 32 channels, then
                                          // the folded ones
constexpr int kF32DyRow = kF32Co * 4;     // bytes of a dy row

struct WgradF32Args {
  const float* x;   // (S, N, H, W, Cin)
  const float* dy;  // (S, N, H, W, Cout)
  float* ws;        // (S, splits, 9, Cin, Cout) partial sums
  int N, H, W, Cin, Cout;  // N images a member
  int splits, steps, halo_rows, stages;  // a member's
  int nci;      // Cin blocks
  int vx, vdy;  // 16-byte copies of x, of dy
};

// Cin channels folded into the last whole block: what is past the last
// whole 32, if at most kF32MaxFold and a whole block exists
__host__ __device__ __forceinline__ int wgrad_f32_fold(int cin) {
  const int rem = cin % kF32Ci;
  return cin > kF32Ci && rem <= kF32MaxFold ? rem : 0;
}

// the bytes of one ring slot: halo rows, then dy rows
__host__ __device__ __forceinline__ int wgrad_f32_slot(int halo_rows) {
  return halo_rows * kF32XRow + kF32BK * kF32DyRow;
}

// blockIdx = (Cin block, Cout block, member * splits + split), as the bf16
// split-K path; warp t sums tap t.  FOLD: the folded channels Cin - FOLD
// .. Cin - 1, summed by every tap warp of the last Cin block from the 16
// bytes past each halo row's 32 channels (its four lanes of a Cout group
// alike: lane lm == 0 writes).
template <int FOLD>
__global__ void __launch_bounds__(kF32WThreads, 2)
wgrad_f32_kernel(WgradF32Args p) {
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int R = p.halo_rows;
  const int slot = wgrad_f32_slot(R);
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_zero = s_ring + p.stages * slot;  // a zero halo row

  const int member = static_cast<int>(blockIdx.z) / p.splits;
  const int split = static_cast<int>(blockIdx.z) - member * p.splits;
  const int HW = p.H * p.W;
  const int P = p.N * HW;
  const float* x = p.x + static_cast<size_t>(member) * P * p.Cin;
  const float* dy = p.dy + static_cast<size_t>(member) * P * p.Cout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap = tid >> 5;
  const int lm = lane & 3, ln = lane >> 2;
  const int c0 = blockIdx.x * kF32Ci;
  const int n0 = blockIdx.y * kF32Co;
  const int f0 = p.Cin - FOLD;          // the first folded channel
  const int cw = min(kF32Ci, f0 - c0);  // the block's whole-32 channels
  const int nw = min(kF32Co, p.Cout - n0);
  const bool folds = FOLD > 0 && static_cast<int>(blockIdx.x) == p.nci - 1;
  const int g0 = static_cast<int>(static_cast<long long>(p.steps) * split /
                                  p.splits);
  const int nsteps = static_cast<int>(static_cast<long long>(p.steps) *
                                      (split + 1) / p.splits) - g0;

  if (tid < kF32XRow / 16)
    reinterpret_cast<uint4*>(smem + (s_zero - s_ring))[tid] =
        make_uint4(0, 0, 0, 0);

  // halo row q is pixel k0 - W - 1 + q; dy row r is pixel k0 + r, zeros
  // past the member's pixels
  auto load_stage = [&](int g, int sl) {
    const uint32_t sh = s_ring + sl * slot;
    const uint32_t sd = sh + R * kF32XRow;
    const int k0 = g * kF32BK;
    const int q0 = k0 - p.W - 1;
    if (p.vx) {
      const int ch = tid & 7;
      for (int q = tid >> 3; q < R; q += kF32WThreads / 8) {
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < P && ch * 4 < cw;
        const float* src =
            ok ? x + static_cast<size_t>(pix) * p.Cin + c0 + ch * 4 : x;
        cp_async16(sh + q * kF32XRow + ch * 16, src, ok);
      }
    } else {
      for (int q = tap; q < R; q += kF32TapWarps) {
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < P;
        if (lane < cw)
          cp_async4(sh + q * kF32XRow + lane * 4,
                    ok ? x + static_cast<size_t>(pix) * p.Cin + c0 + lane : x,
                    ok);
      }
    }
    if (folds) {
      for (int q = tid; q < R; q += kF32WThreads) {
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < P;
#pragma unroll
        for (int f = 0; f < FOLD; ++f)
          cp_async4(sh + q * kF32XRow + kRowBytes + f * 4,
                    ok ? x + static_cast<size_t>(pix) * p.Cin + f0 + f : x,
                    ok);
      }
    }
    if (p.vdy) {
      for (int i = tid; i < kF32BK * 8; i += kF32WThreads) {
        const int r = i >> 3, ch = i & 7;
        const int pix = k0 + r;
        const bool ok = pix < P && ch * 4 < nw;
        const float* src =
            ok ? dy + static_cast<size_t>(pix) * p.Cout + n0 + ch * 4 : dy;
        cp_async16(sd + r * kF32DyRow + ch * 16, src, ok);
      }
    } else {
      for (int r = tap; r < kF32BK; r += kF32TapWarps) {
        const int pix = k0 + r;
        const bool ok = pix < P;
        for (int c = lane; c < nw; c += 32)
          cp_async4(sd + r * kF32DyRow + c * 4,
                    ok ? dy + static_cast<size_t>(pix) * p.Cout + n0 + c : dy,
                    ok);
      }
    }
  };

  // acc[i][j]: Cin c0 + 4lm + i (i < 4) or c0 + 16 + 4lm + i - 4, Cout n0 +
  // 4ln + j; accf[f][j]: Cin f0 + f
  float acc[8][4];
  float accf[FOLD > 0 ? FOLD : 1][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = 0.0f;
#pragma unroll
    for (int f = 0; f < (FOLD > 0 ? FOLD : 1); ++f) accf[f][j] = 0.0f;
  }
  const int kh = tap / 3, kw = tap - kh * 3;

  // K step g in slot sl; F: the folded channels this block sums
  auto compute = [&](int g, int sl, auto fold) {
    constexpr int F = decltype(fold)::value;
    // bit r of the masks: tap `tap`'s source pixel of pixel k0 + r lies
    // inside its image (pixels 0-31, 32-63)
    unsigned mask[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = g * kF32BK + 32 * h + lane;
      bool ok = false;
      if (pix < P) {
        const int rem = pix % HW;
        const int ih = rem / p.W + kh - 1;
        const int iw = rem - (rem / p.W) * p.W + kw - 1;
        ok = ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      }
      mask[h] = __ballot_sync(0xffffffffu, ok);
    }
    const uint32_t sh = s_ring + sl * slot;
    const uint32_t xrow = sh + (kh * p.W + kw) * kF32XRow + lm * 16;
    const uint32_t zrow = s_zero + lm * 16;
    const uint32_t drow = sh + R * kF32XRow + ln * 16;
#pragma unroll 2
    for (int r = 0; r < kF32BK; ++r) {
      const unsigned bits = r < 32 ? mask[0] : mask[1];
      const uint32_t xa = (bits >> (r & 31)) & 1u ? xrow + r * kF32XRow : zrow;
      const float4 a0 = lds128(xa);
      const float4 a1 = lds128(xa + 64);
      const float4 b0 = lds128(drow + r * kF32DyRow);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if constexpr (F > 0) {
        const float4 v = lds128(xa - lm * 16 + kRowBytes);
        const float fv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            accf[f][j] = fmaf(fv[f], bv[j], accf[f][j]);
      }
    }
  };

  const int PD = p.stages - 1;  // steps loaded ahead: 1 or 2
  for (int s = 0; s < PD; ++s) {
    if (s < nsteps) load_stage(g0 + s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait_upto(PD - 1);
    // step kt has landed for every thread; the slot refilled below was
    // last read by step kt - 1, which every warp has finished
    __syncthreads();
    const int next = kt + PD;
    if (next < nsteps) load_stage(g0 + next, next % p.stages);
    cp_async_commit();
    if (folds)
      compute(g0 + kt, kt % p.stages, std::integral_constant<int, FOLD>());
    else
      compute(g0 + kt, kt % p.stages, std::integral_constant<int, 0>());
  }
  cp_async_wait<0>();

  const size_t tap_stride = static_cast<size_t>(p.Cin) * p.Cout;
  float* ws = p.ws + (static_cast<size_t>(blockIdx.z) * 9 + tap) * tap_stride;
  const bool vec = (p.Cout & 3) == 0;
  // row ci of this lane's Cout columns n0 + 4ln .. + 3 from v
  auto write = [&](int ci, const float (&v)[4]) {
    const int co = n0 + 4 * ln;
    float* dst = ws + static_cast<size_t>(ci) * p.Cout + co;
    if (vec && co + 4 <= p.Cout) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (co + j < p.Cout) dst[j] = v[j];
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = (i < 4 ? 4 * lm + i : 16 + 4 * lm + i - 4);
    if (ci < cw) write(c0 + ci, acc[i]);
  }
  if (folds && lm == 0) {
#pragma unroll
    for (int f = 0; f < (FOLD > 0 ? FOLD : 1); ++f) write(f0 + f, accf[f]);
  }
}

template <int FOLD>
cudaError_t launch_f32_fold(const WgradF32Args& p, int S, long long bytes,
                            int device, int optin, cudaStream_t st) {
  auto kernel = wgrad_f32_kernel<FOLD>;
  static std::atomic<bool> opted[kMaxDevices];
  if (!opted[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid(p.nci, (p.Cout + kF32Co - 1) / kF32Co, S * p.splits);
  kernel<<<grid, kF32WThreads, static_cast<size_t>(bytes), st>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_partials(const void* x, const void* dy, float* ws,
                                int S, int N, int H, int W, int Cin, int Cout,
                                int splits, int stages, int device,
                                cudaStream_t st) {
  const long long P = static_cast<long long>(N) * H * W;
  if (P + kF32BK + 2LL * W + 2 >= (1LL << 31) || stages < 2 || stages > 3)
    return cudaErrorInvalidValue;
  const int fold = wgrad_f32_fold(Cin);
  const int R = kF32BK + 2 * W + 2;
  const WgradF32Args p{
      static_cast<const float*>(x), static_cast<const float*>(dy), ws, N, H,
      W, Cin, Cout, splits, static_cast<int>((P + kF32BK - 1) / kF32BK), R,
      stages, (Cin - fold + kF32Ci - 1) / kF32Ci,
      Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0,
      Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0};
  // members and their splits share grid dimension z (at most 65,535)
  if (splits > p.steps || static_cast<long long>(S) * splits > 65535)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;
  const long long bytes =
      128LL + static_cast<long long>(stages) * wgrad_f32_slot(R) + kF32XRow;
  if (bytes > optin) return cudaErrorInvalidValue;  // images too wide
  switch (fold) {
    case 0: return launch_f32_fold<0>(p, S, bytes, device, optin, st);
    case 1: return launch_f32_fold<1>(p, S, bytes, device, optin, st);
    case 2: return launch_f32_fold<2>(p, S, bytes, device, optin, st);
    case 3: return launch_f32_fold<3>(p, S, bytes, device, optin, st);
    default: return launch_f32_fold<4>(p, S, bytes, device, optin, st);
  }
}

// ------------------------------------------------------------ the launch

enum WgradPath { kPathSplitK = 0, kPathTma = 1, kPathF32 = 2 };  // wgrad_plan's

cudaError_t launch_split_k(const void* x, const void* dy, float* ws, int S,
                           int N, int H, int W, int Cin, int Cout, int splits,
                           int device, cudaStream_t st) {
  constexpr int BK = kWgradBK;
  constexpr int E = 8;  // bf16 elements a 16-byte chunk
  const long long P = static_cast<long long>(N) * H * W;
  if (P + BK + 2LL * W + 2 >= (1LL << 31)) return cudaErrorInvalidValue;
  const WgradArgs p{x, dy, ws, N, H, W, Cin, Cout, splits,
                    static_cast<int>((P + BK - 1) / BK), BK + 2 * W + 2};
  // members and their splits share grid dimension z (at most 65,535)
  if (splits > p.steps || static_cast<long long>(S) * splits > 65535)
    return cudaErrorInvalidValue;
  const bool vx = Cin % E == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vdy =
      Cout % E == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (vx && vdy) return launch_partials<true, true>(p, S, device, st);
  if (vx) return launch_partials<true, false>(p, S, device, st);
  if (vdy) return launch_partials<false, true>(p, S, device, st);
  return launch_partials<false, false>(p, S, device, st);
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* dy, float* ws, void* out,
                         int S, int N, int H, int W, int Cin, int Cout,
                         int path, int splits, int rows, int stages,
                         int cluster, int device, void* stream) {
  if (S < 1 || S > 65535 || N < 1 || H < 1 || W < 1 || Cin < 1 ||
      Cout < 1 || splits < 1 || 9LL * Cin * Cout >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (kF32 && path == kPathF32 && rows == kF32BK && cluster == 1) {
    err = launch_f32_partials(x, dy, ws, S, N, H, W, Cin, Cout, splits,
                              stages, device, st);
  } else if (!kF32 && path == kPathTma && S == 1) {
    // one member a launch: the tensor maps cover one member's images
    err = launch_tma_partials(x, dy, ws, N, H, W, Cin, Cout, splits, rows,
                              stages, cluster, device, st);
  } else if (!kF32 && path == kPathSplitK && rows == kWgradBK &&
             cluster == 1) {
    err = launch_split_k(x, dy, ws, S, N, H, W, Cin, Cout, splits, device,
                         st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // the partials, one per cluster, in split order
  const int n = 9 * Cin * Cout;
  wgrad_reduce_kernel<T><<<dim3((n + 255) / 256, S), 256, 0, st>>>(
      ws, static_cast<T*>(out), n, splits / cluster);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nodems

// dW (S, 3, 3, Cin, Cout) of T from x (S, N, H, W, Cin) and dy (S, N, H, W,
// Cout), S members each reduced over its own N images (S = 1: a single
// run; the TMA path takes one member a launch); ws: S * splits / cluster
// * 9 * Cin * Cout floats of workspace.  The plan
// (path, splits, rows, stages, cluster) is ops/conv3x3.py::wgrad_plan's; a
// plan the shapes, the pointers or the device cannot run is refused.  Two
// launches on `stream`: the partial sums, then their sum in split order.
extern "C" int conv3x3_wgrad_launch(int dtype, const void* x, const void* dy,
                                    void* ws, void* out, int S, int N, int H,
                                    int W, int Cin, int Cout, int path,
                                    int splits, int rows, int stages,
                                    int cluster, int device, void* stream) {
  using namespace nodems;
  float* w = static_cast<float*>(ws);
  if (dtype == NODEMS_F32)
    return launch_wgrad<float>(x, dy, w, out, S, N, H, W, Cin, Cout, path,
                               splits, rows, stages, cluster, device, stream);
  if (dtype == NODEMS_BF16)
    return launch_wgrad<__nv_bfloat16>(x, dy, w, out, S, N, H, W, Cin, Cout,
                                       path, splits, rows, stages, cluster,
                                       device, stream);
  return cudaErrorInvalidValue;
}
