// Kernel B2: one RK2(u) solve of the flagship ODE block,
//   f(y) = conv2(gelu(conv1(gelu(y)))),  n_steps x 2 stages, forward only.
//
// Replaces neural_ode_metasolver_tpu/ops/pallas_ode_block.py::
// ode_block_rk2_forward (kernel body _ode_block_kernel, which kept the whole
// solve of a batch tile in VMEM).  That does not carry over: one 32x32x64
// image is 128 KB in bf16, so y, k1, the stage input and k2 do not fit in a
// block's 227 KB of shared memory, and the 3x3x128x128 weights alone are
// 288 KB in bf16.  So the solve runs as launches of the implicit-GEMM conv
// of conv3x3.cuh (bf16) or conv3x3_f32.cuh (f32, on the plan the wrapper
// passes) with an epilogue each, in the order ops/ode_block.py's launch
// schedule gives.  In the RHS, h and the stage input are only ever
// used through gelu, so each epilogue writes the gelu'd value and every conv
// is a plain GEMM:
//   0. gy  = T(gelu(y0))                      elementwise, once per solve
//   per step:
//   1. gh  = T(gelu(T(conv1(gy))))            epilogue kGelu
//   2. k1  = conv2(gh) in f32;  gys = T(gelu(T(y + u dt k1)))     kStage1
//   3. gh  = T(gelu(T(conv1(gys))))           kGelu
//   4. y   = T(y + dt (b1 k1 + b2 conv2(gh))), in place;
//      gy  = T(gelu(y)) unless this is the last step              kStage2
// The rounding points are the Pallas kernel's: h is rounded to the compute
// dtype T, k1, k2 and the RK combine stay in f32, and the stage input and
// the new y are rounded to T; gelu of a rounded value is rounded again, as
// its _gelu rounds.  GELU is exact, with CUDA's erff (the Pallas kernel's
// Abramowitz-Stegun _erf exists only because Mosaic has no erf).
//
// Bound on the H100: 32 convs per solve; at (256, 32, 32, 64) or
// (256, 16, 16, 128) that is 618 GFLOP, about 0.63 ms at the bf16 tensor
// rate, against 67 MB of bf16 state (y read once, y written once, 0.02 ms).
// It is bound by operations.  Each launch round-trips gh, k1 and the gelu'd
// state through device memory, which the 50 MB L2 holds only in part.
#include "conv3x3_f32.cuh"

namespace {

template <typename T>
__global__ void gelu_rounded_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = nodems::from_f32<T>(nodems::gelu_exact(nodems::to_f32(x[i])));
}

template <typename T>
cudaError_t launch_gelu(const void* x, void* out, long long n, int device,
                        void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  gelu_rounded_kernel<T><<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_epi(int dtype, const nodems::ConvArgs& p,
                       const nodems::F32Plan& plan, int device,
                       void* stream) {
  if (dtype == NODEMS_F32)
    return nodems::launch_conv3x3_f32<EPI>(p, plan, device, stream);
  if (dtype == NODEMS_BF16)
    return nodems::launch_conv3x3_bf16<EPI>(p, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Step 0: out = T(gelu(x)) over n elements.
extern "C" int ode_block_rk2_gelu_launch(int dtype, const void* x, void* out,
                                         long long n, int device,
                                         void* stream) {
  if (dtype == NODEMS_F32) return launch_gelu<float>(x, out, n, device, stream);
  if (dtype == NODEMS_BF16)
    return launch_gelu<__nv_bfloat16>(x, out, n, device, stream);
  return cudaErrorInvalidValue;
}

// Steps 1-4: one conv with epilogue kGelu, kStage1 or kStage2.  f32 runs
// the plan (path, rows, cols, ksplit, stages) of
// ops/conv3x3.py::conv3x3_f32_plan; bf16 ignores those five arguments.
extern "C" int ode_block_rk2_conv_launch(int dtype, int epilogue,
                                         const void* x, const void* w,
                                         void* out, const void* y, void* k1,
                                         void* aux, int N, int H, int W,
                                         int C, float a, float b1, float b2,
                                         int path, int rows, int cols,
                                         int ksplit, int stages, int device,
                                         void* stream) {
  using namespace nodems;
  const ConvArgs p{x, w, out, y, static_cast<float*>(k1), aux,
                   N, H, W, C, C, a, b1, b2};
  const F32Plan plan{path, rows, cols, ksplit, stages};
  switch (epilogue) {
    case kGelu:
      return launch_epi<kGelu>(dtype, p, plan, device, stream);
    case kStage1:
      return launch_epi<kStage1>(dtype, p, plan, device, stream);
    case kStage2:
      return launch_epi<kStage2>(dtype, p, plan, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
