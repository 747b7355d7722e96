// Direct (implicit-GEMM) 3x3 stride-1 SAME convolution for sm_90a, shared
// by kernel B1 (conv3x3.cu) and kernel B2 (ode_block_rk2.cu).
//
// Layouts are the JAX package's: x (N, H, W, Cin) NHWC, w (3, 3, Cin, Cout)
// HWIO, outputs (N, H, W, Cout) NHWC, all contiguous.  T is float or
// __nv_bfloat16; every product is an f32 FMA and every sum is kept in f32.
//
// One block computes an 8 x 16 pixel tile of one image for 64 output
// channels.  It walks Cin in chunks of 8: the halo'd 10 x 18 x 8 input tile
// and the 3 x 3 x 8 x 64 weight slice are staged in shared memory (as f32,
// zero outside the image and past Cin, so Cin = 3 works), then each of the
// 128 threads accumulates 8 pixels x 8 channels over the 9 taps.  The 9x
// patch matrix of an im2col GEMM is never formed: each input element is
// read from device memory once per block (plus its halo), not 9 times.
//
// Bound on the H100: at the serving shapes a conv does 2*9*Cin*Cout flops
// per pixel against 2*(Cin+Cout) bytes in bf16, about 290 flops a byte at
// Cin = Cout = 64, which sits at the card's bf16 ridge; this kernel runs its
// products on the f32 FMA pipes (67 TFLOP/s), so it is bound by operations
// at the f32 rate, not by bytes.  Tensor-core products (wgmma) are what
// would move it toward the bf16 bound; that is later work.
//
// Template switches:
//   GELU_IN  apply exact GELU (erff) to each input element as it is staged,
//            rounded to T as the Pallas kernel's _gelu rounds to the compute
//            dtype.  gelu(0) = 0, so the zero halo stays exact.
//   EPI      what the epilogue writes, per output element o with f32 sum s:
//     kStore   out[o] = T(s)
//     kStage1  k1[o] = s (f32);   out[o] = T(y[o] + a * s)
//     kStage2  out[o] = T(y[o] + a * (b1 * k1[o] + b2 * s))
//            kStage2 may run in place (out == y): each element is read and
//            then written by the same thread.
#pragma once

#include <cstddef>

#include "common.cuh"

namespace nodems {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kTileCo = 64;
constexpr int kChunkCi = 8;
constexpr int kThreads = 128;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

enum Epilogue { kStore = 0, kStage1 = 1, kStage2 = 2 };

template <typename T, bool GELU_IN, int EPI>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* out,
               const T* y, float* k1, int N, int H, int W, int Cin, int Cout,
               int tiles_h, int tiles_w, float a, float b1, float b2) {
  __shared__ float s_in[kChunkCi][kHaloH][kHaloW];
  __shared__ __align__(16) float s_w[9][kChunkCi][kTileCo];

  const int tid = threadIdx.x;
  const int per_img = tiles_h * tiles_w;
  const int n = blockIdx.x / per_img;
  const int t = blockIdx.x % per_img;
  const int oh0 = (t / tiles_w) * kTileH;
  const int ow0 = (t % tiles_w) * kTileW;
  const int co0 = blockIdx.y * kTileCo;

  // Thread (tp, tc): pixels row prow, columns pcol..pcol+7 of the tile;
  // channels tc*4..tc*4+3 and 32+tc*4..32+tc*4+3 of the channel tile (the
  // split keeps a warp's float4 weight reads free of bank conflicts).
  const int tc = tid & 7;
  const int tp = tid >> 3;
  const int prow = tp >> 1;
  const int pcol = (tp & 1) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const T* xn = x + (size_t)n * H * W * Cin;
  for (int ci0 = 0; ci0 < Cin; ci0 += kChunkCi) {
    for (int idx = tid; idx < kChunkCi * kHaloH * kHaloW; idx += kThreads) {
      const int c = idx % kChunkCi;
      const int p = idx / kChunkCi;
      const int py = p / kHaloW;
      const int px = p % kHaloW;
      const int ih = oh0 + py - 1;
      const int iw = ow0 + px - 1;
      const int ci = ci0 + c;
      float v = 0.0f;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W && ci < Cin) {
        v = to_f32(xn[((size_t)ih * W + iw) * Cin + ci]);
        if (GELU_IN) v = to_f32(from_f32<T>(gelu_exact(v)));
      }
      s_in[c][py][px] = v;
    }
    for (int idx = tid; idx < 9 * kChunkCi * kTileCo; idx += kThreads) {
      const int co = idx % kTileCo;
      const int r = idx / kTileCo;
      const int c = r % kChunkCi;
      const int tap = r / kChunkCi;
      const int ci = ci0 + c;
      const int cg = co0 + co;
      float v = 0.0f;
      if (ci < Cin && cg < Cout) {
        v = to_f32(w[((size_t)tap * Cin + ci) * Cout + cg]);
      }
      s_w[tap][c][co] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int c = 0; c < kChunkCi; ++c) {
          float xin[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) xin[i] = s_in[c][prow + ky][pcol + i + kx];
          const float4 wa =
              *reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][c][tc * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(
              &s_w[ky * 3 + kx][c][32 + tc * 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xin[i], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int oh = oh0 + prow;
  if (oh >= H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ow = ow0 + pcol + i;
    if (ow >= W) continue;
    const size_t pix = ((size_t)n * H + oh) * W + ow;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + (j < 4 ? tc * 4 + j : 32 + tc * 4 + (j - 4));
      if (co >= Cout) continue;
      const size_t o = pix * Cout + co;
      const float s = acc[i][j];
      if (EPI == kStore) {
        out[o] = from_f32<T>(s);
      } else if (EPI == kStage1) {
        k1[o] = s;
        out[o] = from_f32<T>(to_f32(y[o]) + a * s);
      } else {
        out[o] = from_f32<T>(to_f32(y[o]) + a * (b1 * k1[o] + b2 * s));
      }
    }
  }
}

template <typename T, bool GELU_IN, int EPI>
cudaError_t launch_conv3x3(const void* x, const void* w, void* out,
                           const void* y, float* k1, int N, int H, int W,
                           int Cin, int Cout, float a, float b1, float b2,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const dim3 grid((unsigned)N * tiles_h * tiles_w,
                  (unsigned)((Cout + kTileCo - 1) / kTileCo));
  conv3x3_kernel<T, GELU_IN, EPI>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<T*>(out), static_cast<const T*>(y), k1, N, H, W, Cin,
          Cout, tiles_h, tiles_w, a, b1, b2);
  return cudaGetLastError();
}

}  // namespace nodems
