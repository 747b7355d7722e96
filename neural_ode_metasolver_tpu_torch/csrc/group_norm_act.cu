// Kernel B3: GroupNorm (eps, f32 affine) + activation over NHWC, forward.
//
// Replaces neural_ode_metasolver_tpu/ops/pallas_kernels.py::fused_group_norm_act
// (launcher _gn_act_fwd_pallas, body _gn_act_kernel).  The Pallas kernel kept
// a block of samples in VMEM, took one-pass E[x^2] - E[x]^2 moments through
// an MXU matmul against a channel->group indicator matrix, and wrote the
// normalized, activated result: x read from device memory once.
//
// Bound on the H100: bytes.  One read of x and one write of the output
// (2 * N*H*W*C * sizeof(T)) against about 10 f32 operations per element, far
// below the card's ridge; at the MNIST path's shapes, batch 256, f32, that
// is 26 us at (26, 26, 64), 6.6 us at (13, 13, 64) and 1.4 us at (6, 6, 64),
// the last below a launch's own cost.
//
// Design: one block per sample.  The block has C * R threads (R = 512 / C
// rows at a time, at least 1), so thread t always owns channel t % C and
// reads rows t / C, t / C + R, ...: each warp's loads are contiguous along C.
// Where the sample fits in shared memory beside the block's partial sums it
// is staged there on the first pass (STAGED), so x is read from device
// memory once, as on the TPU; otherwise passes 2 and 3 read it again (from
// L2 for the most part).  Statistics are two-pass in f32: each thread sums
// its channel, the block reduces per group in shared memory to the mean,
// then the centred sum of squares to the variance.  The normalize pass
// applies ((x - mean) * rstd) * scale + bias and the activation in f32 and
// rounds once to T.
#include <atomic>
#include <cstddef>

#include "common.cuh"

namespace nodems {

enum Act {
  kActNone = 0,
  kActRelu = 1,
  kActGelu = 2,
  kActTanh = 3,
  kActSoftsign = 4
};

constexpr int kGnMaxC = 1024;
constexpr int kGnRowThreads = 512;

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kActRelu) return v < 0.0f ? 0.0f : v;  // NaN passes, as in torch
  if (ACT == kActGelu) return gelu_exact(v);
  if (ACT == kActTanh) return tanhf(v);
  if (ACT == kActSoftsign) return v / (1.0f + fabsf(v));
  return v;
}

// Per-group sum of s_part (one entry per thread, laid out [row][channel]),
// computed by threads 0..G-1.
__device__ __forceinline__ float group_sum(const float* s_part, int g, int R,
                                           int C, int cg) {
  float t = 0.0f;
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < cg; ++k) t += s_part[r * C + g * cg + k];
  return t;
}

template <typename T, int ACT, bool STAGED>
__global__ void __launch_bounds__(kGnMaxC)
group_norm_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int HW, int C, int G, int R, float eps,
                      int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);  // the sample, when STAGED
  float* s_part = reinterpret_cast<float*>(smem + stage_bytes);
  float* s_mean = s_part + blockDim.x;
  float* s_rstd = s_mean + G;

  const int tid = threadIdx.x;
  const int c = tid % C;
  const int r0 = tid / C;
  const int cg = C / G;
  const int g = c / cg;
  const float count = static_cast<float>(HW) * cg;
  const size_t base = static_cast<size_t>(blockIdx.x) * HW * C;
  const T* xn = x + base;
  T* on = out + base;

  auto load = [&](int p) -> float {
    const size_t i = static_cast<size_t>(p) * C + c;
    return to_f32(STAGED ? s_x[i] : xn[i]);
  };

  // pass 1: the channel's sum over this thread's rows; stage the sample
  float s = 0.0f;
  for (int p = r0; p < HW; p += R) {
    const size_t i = static_cast<size_t>(p) * C + c;
    const T v = xn[i];
    if (STAGED) s_x[i] = v;
    s += to_f32(v);
  }
  s_part[tid] = s;
  __syncthreads();
  if (tid < G) s_mean[tid] = group_sum(s_part, tid, R, C, cg) / count;
  __syncthreads();
  const float mean = s_mean[g];

  // pass 2: centred sum of squares
  float q = 0.0f;
  for (int p = r0; p < HW; p += R) {
    const float d = load(p) - mean;
    q = fmaf(d, d, q);
  }
  s_part[tid] = q;
  __syncthreads();
  if (tid < G)
    s_rstd[tid] = rsqrtf(group_sum(s_part, tid, R, C, cg) / count + eps);
  __syncthreads();
  const float rstd = s_rstd[g];

  // pass 3: normalize, affine, activate, round once
  const float sc = scale[c];
  const float bi = bias[c];
  for (int p = r0; p < HW; p += R) {
    const float y = (load(p) - mean) * rstd * sc + bi;
    on[static_cast<size_t>(p) * C + c] = from_f32<T>(activate<ACT>(y));
  }
}

// The device's opt-in shared memory per block, read on the first launch of
// each kernel instance on each device (later launches pay no host call for
// it).  Dynamic shared memory above 48 KB must be allowed once per kernel
// and device, so the staged kernel is allowed all of it then too.
template <typename T, int ACT>
cudaError_t staged_smem_limit(int device, int* bytes) {
  static std::atomic<int> limit[kMaxDevices];  // 0: not read yet
  int v = limit[device].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(group_norm_act_kernel<T, ACT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (err != cudaSuccess) return err;
    limit[device].store(v, std::memory_order_relaxed);
  }
  *bytes = v;
  return cudaSuccess;
}

template <typename T, int ACT>
cudaError_t launch_group_norm_act(const void* x, const float* scale,
                                  const float* bias, void* out, int N, int HW,
                                  int C, int G, float eps, int device,
                                  cudaStream_t stream) {
  const int R = C >= kGnRowThreads ? 1 : kGnRowThreads / C;
  const int threads = C * R;
  const size_t stats_bytes = sizeof(float) * (threads + 2 * G);
  const size_t sample_bytes = sizeof(T) * static_cast<size_t>(HW) * C;
  const size_t stage_bytes = (sample_bytes + 15) / 16 * 16;
  int optin = 0;
  cudaError_t err = staged_smem_limit<T, ACT>(device, &optin);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (stage_bytes + stats_bytes <= static_cast<size_t>(optin)) {
    group_norm_act_kernel<T, ACT, true>
        <<<N, threads, stage_bytes + stats_bytes, stream>>>(
            xt, scale, bias, ot, HW, C, G, R, eps,
            static_cast<int>(stage_bytes));
  } else {
    group_norm_act_kernel<T, ACT, false>
        <<<N, threads, stats_bytes, stream>>>(xt, scale, bias, ot, HW, C, G,
                                              R, eps, 0);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const float* scale,
                         const float* bias, void* out, int N, int HW, int C,
                         int G, float eps, int device, cudaStream_t stream) {
  switch (act) {
    case kActNone:
      return launch_group_norm_act<T, kActNone>(x, scale, bias, out, N, HW, C,
                                                G, eps, device, stream);
    case kActRelu:
      return launch_group_norm_act<T, kActRelu>(x, scale, bias, out, N, HW, C,
                                                G, eps, device, stream);
    case kActGelu:
      return launch_group_norm_act<T, kActGelu>(x, scale, bias, out, N, HW, C,
                                                G, eps, device, stream);
    case kActTanh:
      return launch_group_norm_act<T, kActTanh>(x, scale, bias, out, N, HW, C,
                                                G, eps, device, stream);
    case kActSoftsign:
      return launch_group_norm_act<T, kActSoftsign>(x, scale, bias, out, N,
                                                    HW, C, G, eps, device,
                                                    stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace nodems

// x, out (N, HW, C) contiguous of the dtype; scale, bias (C,) f32.
extern "C" int group_norm_act_launch(int dtype, int act, const void* x,
                                     const void* scale, const void* bias,
                                     void* out, int N, int HW, int C, int G,
                                     float eps, int device, void* stream) {
  using namespace nodems;
  if (N < 1 || HW < 1 || C < 1 || C > kGnMaxC || G < 1 || C % G != 0)
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32)
    return dispatch_act<float>(act, x, s, b, out, N, HW, C, G, eps, device,
                               st);
  if (dtype == NODEMS_BF16)
    return dispatch_act<__nv_bfloat16>(act, x, s, b, out, N, HW, C, G, eps,
                                       device, st);
  return cudaErrorInvalidValue;
}
