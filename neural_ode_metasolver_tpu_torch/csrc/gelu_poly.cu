// GeLUpoly, forward and backward, elementwise over n values of f32 or bf16:
//   y  = x * phi,   phi = 0.5 * tanh(z) + 0.5,   z = t * q(t^2),
//   t  = clamp(x, -8, 8),  q(s) = c0 + c1 s + c2 s^2 + c3 s^3 + c4 s^4;
//   dx = g * (phi + x * 0.5 * (1 - tanh(z)^2) * (q + 2 t^2 q'(t^2))
//                 * [-8 <= x <= 8]).
// The clamp's mask is inclusive, as torch.clamp's backward is.  Both
// kernels read x (and g) in its dtype, compute in f32 with the accurate
// tanhf and round once to x's dtype, as kernel B3 does for its activation;
// the f32 arithmetic is the plain versions' (ops/gelu_poly.py) op for op.
// The backward recomputes everything from x: autograd saves x alone.
//
// Replaces no TPU kernel: on the TPU, XLA fused the activation
// (neural_ode_metasolver_tpu/models/nn.py::gelu_poly) into the code around
// it.  In eager PyTorch the composition (models/nn.py, ops/gelu_poly.py::
// gelu_poly_reference) is about 15 aten kernels forward and 22 backward,
// each a pass over the tensor, and the flagship train step calls it 69
// times a pass: most of its elementwise device time and of its launches.
//
// Bound on the H100: bytes.  Forward reads x and writes y, backward reads
// x and g and writes dx: at (256, 32, 32, 64) in bf16, 67 MB and 101 MB,
// 20 and 30 us at 3.35 TB/s, against about 40 f32 operations a value.
// Each thread moves 16-byte vectors (4 f32 or 8 bf16 values) in a
// grid-stride loop; a ragged end, or a pointer that is not 16-byte
// aligned, takes one value at a time.  The launch is on the caller's
// stream and allocates nothing.
#include <atomic>

#include "common.cuh"

namespace {

// The coefficients as the plain version's f32 arithmetic sees them: each
// Python float (a double), and each derivative's k * c_k taken in double,
// rounded once to f32.  q(s) = c0 + c1 s + ... + c4 s^4, q'(s) = d0 + d1 s
// + d2 s^2 + d3 s^3.
constexpr float kC0 = static_cast<float>(0.7978281363504355);
constexpr float kC1 = static_cast<float>(0.036468789125448826);
constexpr float kC2 = static_cast<float>(-0.0001248603561668213);
constexpr float kC3 = static_cast<float>(-3.058127220985254e-05);
constexpr float kC4 = static_cast<float>(1.119098134045954e-06);
constexpr float kD0 = kC1;
constexpr float kD1 = static_cast<float>(2 * -0.0001248603561668213);
constexpr float kD2 = static_cast<float>(3 * -3.058127220985254e-05);
constexpr float kD3 = static_cast<float>(4 * 1.119098134045954e-06);
constexpr float kClamp = 8.0f;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;  // grid-stride blocks, at most, an SM

// Every product and sum rounds on its own (__fmul_rn, __fadd_rn: never
// contracted into an FMA), in the plain version's order, so the kernels
// compute its f32 arithmetic op for op.  Where that arithmetic cancels
// (1 - tanh^2 near saturation, 0.5 tanh + 0.5 for x < -4) an FMA would
// move the result by more than a bf16 ulp against it.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float poly_q(float s) {
  return add(mul(add(mul(add(mul(add(mul(kC4, s), kC3), s), kC2), s), kC1),
                 s),
             kC0);
}

__device__ __forceinline__ float gelu_poly_f(float x) {
  const float t = fminf(fmaxf(x, -kClamp), kClamp);
  const float th = tanhf(mul(t, poly_q(mul(t, t))));
  return mul(x, add(mul(0.5f, th), 0.5f));
}

__device__ __forceinline__ float gelu_poly_grad_f(float x, float g) {
  const float t = fminf(fmaxf(x, -kClamp), kClamp);
  const float s = mul(t, t);
  const float q = poly_q(s);
  const float dq = add(mul(add(mul(add(mul(kD3, s), kD2), s), kD1), s), kD0);
  const float th = tanhf(mul(t, q));
  const float dz = add(q, mul(mul(2.0f, s), dq));
  const float slope =
      mul(mul(mul(x, 0.5f), add(1.0f, -mul(th, th))), dz);
  const bool inside = x >= -kClamp && x <= kClamp;
  return mul(g, add(add(mul(0.5f, th), 0.5f), inside ? slope : 0.0f));
}

// V values of T, aligned to their size: one 16-byte access, or one value
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// y = gelu_poly(x): V values a thread at a time (16 bytes, or 1).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gelu_poly_kernel(const T* __restrict__ x, T* __restrict__ y,
                     long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = first; i < nvec; i += stride) {
    const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
    Pack<T, V> b;
#pragma unroll
    for (int j = 0; j < V; ++j)
      b.v[j] = nodems::from_f32<T>(gelu_poly_f(nodems::to_f32(a.v[j])));
    reinterpret_cast<Pack<T, V>*>(y)[i] = b;
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    y[i] = nodems::from_f32<T>(gelu_poly_f(nodems::to_f32(x[i])));
}

// dx = g * gelu_poly'(x), as the forward.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gelu_poly_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / V;
  for (long long i = first; i < nvec; i += stride) {
    const Pack<T, V> a = reinterpret_cast<const Pack<T, V>*>(x)[i];
    const Pack<T, V> b = reinterpret_cast<const Pack<T, V>*>(g)[i];
    Pack<T, V> c;
#pragma unroll
    for (int j = 0; j < V; ++j)
      c.v[j] = nodems::from_f32<T>(gelu_poly_grad_f(
          nodems::to_f32(a.v[j]), nodems::to_f32(b.v[j])));
    reinterpret_cast<Pack<T, V>*>(dx)[i] = c;
  }
  for (long long i = nvec * V + first; i < n; i += stride)
    dx[i] = nodems::from_f32<T>(
        gelu_poly_grad_f(nodems::to_f32(x[i]), nodems::to_f32(g[i])));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks of a launch over `units` threads' work, at most kBlocksPerSm an
// SM of the device (the SM count read once a device).
cudaError_t grid_for(long long units, int device, unsigned* grid) {
  static std::atomic<int> sms[nodems::kMaxDevices];  // 0: not read yet
  int v = sms[device].load(std::memory_order_relaxed);
  if (v == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms[device].store(v, std::memory_order_relaxed);
  }
  const long long most = static_cast<long long>(v) * kBlocksPerSm;
  const long long want = (units + kThreads - 1) / kThreads;
  *grid = static_cast<unsigned>(want < most ? (want > 0 ? want : 1) : most);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, long long n, int device,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const bool vec = aligned16(x) && aligned16(y);
  unsigned grid = 0;
  const cudaError_t err = grid_for(vec ? n / V : n, device, &grid);
  if (err != cudaSuccess) return err;
  if (vec)
    gelu_poly_kernel<T, V><<<grid, kThreads, 0, stream>>>(xp, yp, n);
  else
    gelu_poly_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, yp, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, void* dx, long long n,
                       int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  const bool vec = aligned16(x) && aligned16(g) && aligned16(dx);
  unsigned grid = 0;
  const cudaError_t err = grid_for(vec ? n / V : n, device, &grid);
  if (err != cudaSuccess) return err;
  if (vec)
    gelu_poly_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(xp, gp, dp, n);
  else
    gelu_poly_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, gp, dp, n);
  return cudaGetLastError();
}

cudaError_t check_args(long long n, int device) {
  if (n < 1 || device < 0 || device >= nodems::kMaxDevices)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// y = gelu_poly(x) over n values of dtype (NODEMS_F32 or NODEMS_BF16).
extern "C" int gelu_poly_launch(int dtype, const void* x, void* y,
                                long long n, int device, void* stream) {
  cudaError_t err = check_args(n, device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32) return launch_fwd<float>(x, y, n, device, s);
  if (dtype == NODEMS_BF16)
    return launch_fwd<__nv_bfloat16>(x, y, n, device, s);
  return cudaErrorInvalidValue;
}

// dx = g * gelu_poly'(x) over n values of dtype.
extern "C" int gelu_poly_bwd_launch(int dtype, const void* x, const void* g,
                                    void* dx, long long n, int device,
                                    void* stream) {
  cudaError_t err = check_args(n, device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32) return launch_bwd<float>(x, g, dx, n, device, s);
  if (dtype == NODEMS_BF16)
    return launch_bwd<__nv_bfloat16>(x, g, dx, n, device, s);
  return cudaErrorInvalidValue;
}
