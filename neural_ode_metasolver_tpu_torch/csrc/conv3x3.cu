// Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC.
//
// Replaces neural_ode_metasolver_tpu/ops/pallas_im2col.py::conv3x3_im2col_gemm
// (the Pallas GEMM _gemm_kernel over the host-built im2col patch matrix).
// The TPU design built the (N*H*W, 9*Cin) patch matrix in device memory and
// padded K and Cout to 128 for Mosaic's tiles; that 9x traffic was its cost.
// Here the same GEMM is implicit: conv3x3.cuh gathers each K step's patch
// rows straight into shared memory, bf16 products run on the tensor cores.
// Bound and design notes: conv3x3.cuh.
#include "conv3x3.cuh"

// S members of N images each: x (S, N, H, W, Cin), w (S, 3, 3, Cin, Cout),
// out (S, N, H, W, Cout); S = 1 is a single run.
extern "C" int conv3x3_same_launch(int dtype, const void* x, const void* w,
                                   void* out, int S, int N, int H, int W,
                                   int Cin, int Cout, int device,
                                   void* stream) {
  using namespace nodems;
  const ConvArgs p{x, w, out, nullptr, nullptr, nullptr, N, H, W, Cin, Cout,
                   0.f, 0.f, 0.f, S};
  if (dtype == NODEMS_F32) return launch_conv3x3<float, kStore>(p, device, stream);
  if (dtype == NODEMS_BF16)
    return launch_conv3x3<__nv_bfloat16, kStore>(p, device, stream);
  return cudaErrorInvalidValue;
}

// The path launch_conv3x3 takes for these shapes on `device`
// (nodems::ConvPath), or -1 for arguments it refuses.
extern "C" int conv3x3_path(int dtype, int N, int H, int W, int Cin, int Cout,
                            int device) {
  using namespace nodems;
  const ConvArgs p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   N, H, W, Cin, Cout, 0.f, 0.f, 0.f};
  int optin = 0;
  if (conv3x3_prepare(p, device, &optin) != cudaSuccess) return -1;
  if (dtype == NODEMS_F32) return conv_path<float, kStore>(p, optin);
  if (dtype == NODEMS_BF16) return conv_path<__nv_bfloat16, kStore>(p, optin);
  return -1;
}
