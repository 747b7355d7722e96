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
// Design:
//  * Split K.  The K steps (BK pixels each) are cut into S contiguous
//    ranges (ops/conv3x3.py::wgrad_splits: about one block per SM over the
//    (Cin, Cout) tiles).  A block sums its range in f32 registers and
//    writes its partial (9, Cin, Cout) tile to a workspace; a second launch
//    adds each element's S partials in range order and rounds once.  No
//    float atomics, so a launch repeats its bits.
//  * A block owns one 128-byte chunk of Cin (64 bf16 or 32 f32 channels),
//    one of Cout, and all nine taps: warp t computes tap t.  Each K step
//    copies into shared memory, once, the x halo the step's nine taps read
//    (pixels k0-W-1 .. k0+BK+W, the forward halo kernel's trick) and the
//    step's dy rows.  Tap (kh, kw) reads the halo shifted by kh*W + kw
//    rows, or a zero row where the source pixel lies outside its image (a
//    9-bit mask per pixel, written when the step is copied).
//  * bf16: mma.sync m16n8k16 on the tensor cores.  x and dy lie
//    pixel-major (K-major for this GEMM), so ldmatrix.trans gathers both
//    operands, one row address per lane (which is how the padding's zero
//    row gets in); a warp holds its tap's 64 x 64 tile, 128 sums a thread.
//    f32: full-f32 FMAs, 4 x 8 sums a lane of a warp's 32 x 32 tile.
//  * A ring of 3 K steps filled by 16-byte cp.async where the channel count
//    and the pointer allow, else by element copies into a ring zeroed once.
#include "conv3x3.cuh"

namespace nodems {
namespace {

constexpr int kWarps = 9;  // one per tap
constexpr int kWThreads = 32 * kWarps;
constexpr int kStages = 3;

// pixels per K step (ops/conv3x3.py::WGRAD_BK)
template <typename T>
struct WgradBK {
  static constexpr int value = std::is_same<T, float>::value ? 64 : 128;
};

struct WgradArgs {
  const void* x;   // (N, H, W, Cin)
  const void* dy;  // (N, H, W, Cout)
  float* ws;       // (splits, 9, Cin, Cout) partial sums
  int N, H, W, Cin, Cout;
  int splits, steps, halo_rows;
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

// C (9-tap tile) of one block: blockIdx = (Cin chunk, Cout chunk, split).
// VX / VDY: 16-byte copies of x / dy (channels a multiple of 16 bytes and
// the pointer aligned), else element copies.
template <typename T, bool VX, bool VDY>
__global__ void __launch_bounds__(kWThreads, 1)
wgrad_partial_kernel(WgradArgs p) {
  constexpr int BK = WgradBK<T>::value;
  constexpr int CH = kRowBytes / static_cast<int>(sizeof(T));
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int PD = kStages - 1;  // steps loaded ahead
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int kDyBytes = BK * kRowBytes;

  extern __shared__ __align__(128) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int R = p.halo_rows;
  const int halo_bytes = R * kRowBytes;
  const int slot = slot_bytes<BK>(R);
  char* s_zero = smem + kStages * slot;  // one row of zeros

  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tap = tid >> 5;
  const int HW = p.H * p.W;
  const int P = p.N * HW;
  const int c0 = blockIdx.x * CH;
  const int n0 = blockIdx.y * CH;
  const int split = blockIdx.z;
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

  // bf16: acc[(mi * 8 + nj) * 4 + i], the m16n8 tile (mi, nj) of the warp's
  // 64 x 64; f32: acc[i * 8 + j], channel 4*(lane&7)+i, column 8*(lane>>3)+j
  constexpr int kAcc = kMma ? 128 : 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int toff = (tap / 3) * p.W + tap % 3;  // halo row of pixel row 0

  auto compute = [&](int sl) {
    const char* sh = smem + sl * slot;
    const char* sd = sh + halo_bytes;
    const uint16_t* sm = reinterpret_cast<const uint16_t*>(sd + kDyBytes);
    if constexpr (kMma) {
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
    } else {
      const int cig = lane & 7, cog = lane >> 3;
      for (int r = 0; r < BK; ++r) {
        if (!((sm[r] >> tap) & 1u)) continue;  // uniform across the warp
        const float4 a = *reinterpret_cast<const float4*>(
            sh + swz(r + toff, cig, kRowBytes));
        const float4 b0 =
            *reinterpret_cast<const float4*>(sd + swz(r, 2 * cog, kRowBytes));
        const float4 b1 = *reinterpret_cast<const float4*>(
            sd + swz(r, 2 * cog + 1, kRowBytes));
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
      }
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

  float* ws = p.ws + (static_cast<size_t>(split) * 9 + tap) *
                         static_cast<size_t>(p.Cin) * p.Cout;
  if constexpr (kMma) {
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
  } else {
    const int cig = lane & 7, cog = lane >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ci = c0 + 4 * cig + i, co = n0 + 8 * cog + j;
        if (ci < p.Cin && co < p.Cout)
          ws[static_cast<size_t>(ci) * p.Cout + co] = acc[i * 8 + j];
      }
  }
}

// out[i] = T(sum over k in order of ws[k][i])
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[static_cast<size_t>(k) * n + i];
  out[i] = from_f32<T>(s);
}

template <typename T, bool VX, bool VDY>
cudaError_t launch_partials(const WgradArgs& p, int device,
                            cudaStream_t st) {
  constexpr int BK = WgradBK<T>::value;
  constexpr int CH = kRowBytes / static_cast<int>(sizeof(T));
  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;
  const long long bytes =
      128LL + kStages * static_cast<long long>(slot_bytes<BK>(p.halo_rows)) +
      kRowBytes;
  if (bytes > optin) return cudaErrorInvalidValue;  // images too wide
  auto kernel = wgrad_partial_kernel<T, VX, VDY>;
  // the whole opt-in size once per device, on the first launch (which
  // callers make outside any CUDA-graph capture): the halo depends on W
  static std::atomic<bool> opted[kMaxDevices];
  if (!opted[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((p.Cin + CH - 1) / CH, (p.Cout + CH - 1) / CH, p.splits);
  kernel<<<grid, kWThreads, static_cast<size_t>(bytes), st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* dy, float* ws, void* out,
                         int N, int H, int W, int Cin, int Cout, int splits,
                         int device, void* stream) {
  constexpr int BK = WgradBK<T>::value;
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const long long P = static_cast<long long>(N) * H * W;
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || splits < 1 ||
      P + BK + 2LL * W + 2 >= (1LL << 31) ||
      9LL * Cin * Cout >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WgradArgs p{x, dy, ws, N, H, W, Cin, Cout, splits,
                    static_cast<int>((P + BK - 1) / BK), BK + 2 * W + 2};
  const bool vx = Cin % E == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vdy =
      Cout % E == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (vx && vdy) err = launch_partials<T, true, true>(p, device, st);
  else if (vx) err = launch_partials<T, true, false>(p, device, st);
  else if (vdy) err = launch_partials<T, false, true>(p, device, st);
  else err = launch_partials<T, false, false>(p, device, st);
  if (err != cudaSuccess) return err;
  const int n = 9 * Cin * Cout;
  wgrad_reduce_kernel<T><<<(n + 255) / 256, 256, 0, st>>>(
      ws, static_cast<T*>(out), n, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nodems

// dW (3, 3, Cin, Cout) of T from x (N, H, W, Cin) and dy (N, H, W, Cout);
// ws: splits * 9 * Cin * Cout floats of workspace.  Two launches on
// `stream`: the partial sums, then their sum in split order.
extern "C" int conv3x3_wgrad_launch(int dtype, const void* x, const void* dy,
                                    void* ws, void* out, int N, int H, int W,
                                    int Cin, int Cout, int splits, int device,
                                    void* stream) {
  using namespace nodems;
  float* w = static_cast<float*>(ws);
  if (dtype == NODEMS_F32)
    return launch_wgrad<float>(x, dy, w, out, N, H, W, Cin, Cout, splits,
                               device, stream);
  if (dtype == NODEMS_BF16)
    return launch_wgrad<__nv_bfloat16>(x, dy, w, out, N, H, W, Cin, Cout,
                                       splits, device, stream);
  return cudaErrorInvalidValue;
}
