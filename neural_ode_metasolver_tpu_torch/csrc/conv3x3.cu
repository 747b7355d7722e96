// Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC.
//
// Replaces neural_ode_metasolver_tpu/ops/pallas_im2col.py::conv3x3_im2col_gemm
// (the Pallas GEMM _gemm_kernel over the host-built im2col patch matrix).
// The TPU design built the (N*H*W, 9*Cin) patch matrix in device memory and
// padded K and Cout to 128 for Mosaic's tiles; that 9x traffic was its cost.
// Here the same GEMM is implicit: the kernels copy each block's input
// pixels into shared memory, bf16 products run on the tensor cores
// (conv3x3.cuh), f32 ones as full-f32 FMAs (conv3x3_f32.cuh).  Bound and
// design notes: those headers.
#include "conv3x3_f32.cuh"

// S members of N images each: x (S, N, H, W, Cin), w (S, 3, 3, Cin, ldw)
// of which columns 0 .. Cout-1 are read, out (S, N, H, W, Cout); S = 1 is
// a single run.  f32 runs the plan (path, rows, cols, ksplit, stages) of
// ops/conv3x3.py::conv3x3_f32_plan and refuses one it cannot run; bf16
// picks its path itself, ignores those five arguments and takes ldw ==
// Cout only.
extern "C" int conv3x3_same_launch(int dtype, const void* x, const void* w,
                                   void* out, int S, int N, int H, int W,
                                   int Cin, int Cout, int ldw, int path,
                                   int rows, int cols, int ksplit, int stages,
                                   int device, void* stream) {
  using namespace nodems;
  const ConvArgs p{x, w, out, nullptr, nullptr, nullptr, N, H, W, Cin, Cout,
                   0.f, 0.f, 0.f, S, ldw};
  if (dtype == NODEMS_F32)
    return launch_conv3x3_f32<kStore>(p, F32Plan{path, rows, cols, ksplit,
                                                 stages},
                                      device, stream);
  if (dtype == NODEMS_BF16 && ldw == Cout)
    return launch_conv3x3_bf16<kStore>(p, device, stream);
  return cudaErrorInvalidValue;
}

// The path (nodems::ConvPath) a launch with these arguments runs on
// `device`: bf16 the one conv_path picks, f32 the plan's if the launcher
// accepts it; -1 for arguments it refuses.
extern "C" int conv3x3_path(int dtype, int N, int H, int W, int Cin, int Cout,
                            int path, int rows, int cols, int ksplit,
                            int stages, int device) {
  using namespace nodems;
  const ConvArgs p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   N, H, W, Cin, Cout, 0.f, 0.f, 0.f};
  int optin = 0;
  if (conv3x3_prepare(p, device, &optin) != cudaSuccess) return -1;
  if (dtype == NODEMS_F32) {
    F32Geom g{};
    long long smem = 0;
    return f32_plan_geom(p, F32Plan{path, rows, cols, ksplit, stages}, optin,
                         &g, &smem);
  }
  if (dtype == NODEMS_BF16) return conv_path<kStore>(p, optin);
  return -1;
}
