// Kernel B3: GroupNorm (eps, f32 affine) + activation over NHWC, forward.
//
// Replaces neural_ode_metasolver_tpu/ops/pallas_kernels.py::fused_group_norm_act
// (launcher _gn_act_fwd_pallas, body _gn_act_kernel).  The Pallas kernel kept
// a block of whole samples in VMEM, took one-pass E[x^2] - E[x]^2 moments
// through an MXU matmul against a channel->group indicator matrix and wrote
// the normalized, activated result: x read from device memory once.
//
// Bound on the H100: bytes.  One read of x and one write of the output
// (2 * N*H*W*C * sizeof(T)) against about 10 f32 operations per element, far
// below the card's ridge.  At the MNIST path's shapes, batch 256, f32, at
// 3.35 TB/s: 26.4 us at (26, 26, 64), 6.6 us at (13, 13, 64) and 1.4 us at
// (6, 6, 64), the last about one launch's own cost.  An SM cannot hold many
// samples as VMEM did, so the design follows what an SM has instead.
//
// Design.  The wrapper's launch plan (ops/group_norm.py::launch_plan) is
// checked here (plan_args) and then run as given:
// - A CTA of W warps owns a slice of one sample.  Thread t always reads the
//   same vector column t % P (16 bytes along C: 4 f32 or 8 bf16 channels;
//   one element where x or C is not 16-byte aligned) of pixel rows t / P,
//   t / P + R, ...: a warp's accesses are contiguous and each thread's
//   channels, so its groups, never change.
// - Register path, MNIST's 6x6 and 13x13 (one CTA a sample): each thread
//   loads its few vectors once into registers; the two-pass f32 statistics
//   and the normalize pass read them there.  Small samples are
//   latency-bound, not byte-bound: a block's time is its threads' serial
//   chain (load, two reductions, store), so the plan spreads a sample over
//   enough warps that a thread holds about 32 elements.
// - Cluster path, MNIST's 26x26 (samples too large for one CTA's
//   registers): the sample's pixels are cut into k <= 8 slices, one per CTA
//   of a thread-block cluster, each held in registers.  The CTAs' partial
//   group sums meet in distributed shared memory, once for the mean and
//   once for the centred squares; every CTA adds the k partials in rank
//   order, so the result is the same bits on every launch.  x is read from
//   memory once, and several CTAs share an SM instead of one staged sample.
// - Both take their group sums by shuffles: a pixel's vector columns divide
//   a warp (C / V a power of two up to 32) and groups align with vectors, so
//   each thread adds its own channels of a group and `__shfl_xor_sync`
//   finishes the warp with no branch; W > 1 warps or k > 1 CTAs then add
//   the warps' sums through shared memory, one thread a group, into the
//   group totals every thread reads from its own CTA.
// - Re-reading path: every other layout (group sums that shuffles cannot
//   finish, one-element access) and slices too large even for 8 CTAs.  The
//   same CTA or cluster layout, but each pass reads its slice again (mostly
//   from L1 or L2), and each thread writes per-channel partials to shared
//   memory, where one thread a group adds them.  Either way the order of
//   every sum is fixed.
// The normalize pass applies (x - mean) * (rstd * scale) + bias and the
// activation in f32 and rounds once to T, with 16-byte stores.
#include "group_norm_act.cuh"

namespace nodems {

// At most 128 registers a thread, so two 8-warp blocks share an SM (at
// 13x13 one block an SM would run the batch of 256 in two waves).  REGS > 0
// (register and cluster paths) holds x in registers and takes shuffled
// group sums; REGS == 0 re-reads x and sums through shared memory.
template <typename T, int ACT, int V, int REGS>
__global__ void __launch_bounds__(kGnMaxThreads, 2)
gn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ out,
              const GnArgs a) {
  constexpr bool SHUFFLE = REGS > 0;
  using IO = Io<T, V>;
  using Raw = typename IO::Raw;
  extern __shared__ __align__(16) float smem[];

  const int t = static_cast<int>(threadIdx.x);
  const int rank = a.k > 1 ? cluster_rank() : 0;
  const int n = a.k > 1 ? cluster_index() : static_cast<int>(blockIdx.x);
  scale += member_offset(n, a);
  bias += member_offset(n, a);
  const int col0 = SHUFFLE ? t & (a.P - 1) : t % a.P;
  const int row0 = SHUFFLE ? t >> a.lg_P : t / a.P;

  // this CTA's slice of the sample: pixels [p0, p0 + npx)
  const int p0 = min(a.HW, rank * a.per);
  const int npx = min(a.HW, p0 + a.per) - p0;
  const bool owner = row0 < a.R;  // holds a row slot
  int nrows = 0;
  if (owner && row0 < npx)
    nrows = SHUFFLE ? (npx - row0 + a.R - 1) >> a.lg_R
                    : (npx - row0 + a.R - 1) / a.R;
  const int ncols = SHUFFLE ? 1 : (owner ? (a.vpp - col0 + a.P - 1) / a.P : 0);
  const int cnt = nrows * ncols;
  const size_t start =
      (static_cast<size_t>(n) * a.HW + p0 + row0) * a.C +
      static_cast<size_t>(col0) * V;
  const T* xs = x + start;
  T* os = out + start;
  const size_t row_step = static_cast<size_t>(a.R) * a.C;
  const int col_step = a.P * V;

  // shared memory: SHUFFLE [2][warps][G], the cluster's [2][G] and the
  // totals [G]; else [R][C] then [4][G]
  float* s_w1 = smem;
  float* s_w2 = s_w1 + a.warps * a.G;
  float* s_cta1 = s_w2 + a.warps * a.G;
  float* s_cta2 = s_cta1 + a.G;
  float* s_tot = s_cta2 + a.G;
  float* s_ch = smem;
  float* s_part1 = s_ch + a.R * a.C;
  float* s_part2 = s_part1 + a.G;
  float* s_mean = s_part2 + a.G;
  float* s_rstd = s_mean + a.G;

  // the current column's channel means, scale (times rstd once known) and
  // bias (SHUFFLE: of its one column)
  float mch[V], sc[V], bi[V];
  auto column_affine = [&](int j) {
    const int c0 = (col0 + j * a.P) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sc[v] = __ldg(scale + c0 + v);
      bi[v] = __ldg(bias + c0 + v);
    }
  };
  auto column_stats = [&](int j, const float* s_stat, float (&dst)[V]) {
    const int c0 = (col0 + j * a.P) * V;
    const int cg = a.C / a.G;
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = s_stat[(c0 + v) / cg];
  };
  auto flush = [&](int j, float (&acc)[V]) {  // !SHUFFLE: a column is done
    float* p = s_ch + row0 * a.C + (col0 + j * a.P) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = acc[v];
      acc[v] = 0.0f;
    }
  };

  // SHUFFLE: the column's scale and bias in flight beside x
  if (SHUFFLE && cnt > 0) column_affine(0);

  Raw regs[REGS > 0 ? REGS : 1];
  auto get = [&](int kk, size_t off) -> Raw {
    if constexpr (REGS > 0) return regs[kk];
    return IO::load(xs + off);
  };
  auto walk = [&](auto&& f) {
    visit<REGS, SHUFFLE>(cnt, nrows, row_step, col_step, f);
  };

  // pass 1: the sum of each of the thread's channels over its rows
  if constexpr (REGS > 0)
    walk([&](int kk, int, int, size_t off) { regs[kk] = IO::load(xs + off); });
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (!SHUFFLE && owner && nrows == 0)
    for (int j = 0; j < ncols; ++j) flush(j, acc);
  walk([&](int kk, int j, int r, size_t off) {
    float f[V];
    IO::unpack(get(kk, off), f);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += f[v];
    if (!SHUFFLE && r == nrows - 1) flush(j, acc);
  });
  if constexpr (SHUFFLE) {
    shuffle_group_total<V>(acc, a, t, col0, s_w1, s_cta1, s_tot);
#pragma unroll
    for (int v = 0; v < V; ++v) mch[v] = acc[v] * a.inv_count;
  } else {
    shared_group_total(a, t, s_ch, s_part1, s_mean,
                       [&](float s) { return s * a.inv_count; });
  }

  // pass 2: centred squares, from the registers (or x again)
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (!SHUFFLE && owner && nrows == 0)
    for (int j = 0; j < ncols; ++j) flush(j, acc);
  walk([&](int kk, int j, int r, size_t off) {
    if (!SHUFFLE && r == 0) column_stats(j, s_mean, mch);
    float f[V];
    IO::unpack(get(kk, off), f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - mch[v];
      acc[v] = fmaf(d, d, acc[v]);
    }
    if (!SHUFFLE && r == nrows - 1) flush(j, acc);
  });
  if constexpr (SHUFFLE) {
    shuffle_group_total<V>(acc, a, t, col0, s_w2, s_cta2, s_tot);
#pragma unroll
    for (int v = 0; v < V; ++v)
      sc[v] *= rsqrtf(fmaf(acc[v], a.inv_count, a.eps));
  } else {
    shared_group_total(a, t, s_ch, s_part2, s_rstd, [&](float q) {
      return rsqrtf(fmaf(q, a.inv_count, a.eps));
    });
  }
  // no CTA may leave while another still reads its shared memory
  if (a.k > 1) cluster_arrive();

  // pass 3: normalize, affine, activate, round once, store
  walk([&](int kk, int j, int r, size_t off) {
    if (!SHUFFLE && r == 0) {
      float rch[V];
      column_stats(j, s_mean, mch);
      column_stats(j, s_rstd, rch);
      column_affine(j);
#pragma unroll
      for (int v = 0; v < V; ++v) sc[v] *= rch[v];
    }
    float f[V];
    IO::unpack(get(kk, off), f);
#pragma unroll
    for (int v = 0; v < V; ++v)
      f[v] = activate<ACT>(fmaf(f[v] - mch[v], sc[v], bi[v]));
    IO::store(os + off, f);
  });
  if (a.k > 1) cluster_wait();
}

template <typename T, int ACT, int V, int REGS>
cudaError_t launch_gn(const void* x, const float* scale, const float* bias,
                      void* out, int S, int N, int HW, int C, int G,
                      float eps, const GnPlan& p, int device,
                      cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  auto kernel = gn_act_kernel<T, ACT, V, REGS>;
  GnArgs a;
  long long smem = 0;
  if (S < 1 || N < 1 ||
      static_cast<long long>(S) * N * p.cluster >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err =
      plan_args(p, sizeof(T), S * N, HW, C, G, eps, x, out, false, &a,
                &smem);
  if (err != cudaSuccess) return err;
  a.nm = N;
  N *= S;
  err = allow_smem(kernel, device, smem, allowed);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const unsigned threads = p.warps * 32;
  if (p.cluster == 1) {
    kernel<<<N, threads, smem, stream>>>(xt, scale, bias, ot, a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N) * p.cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xt, scale, bias, ot, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instances: 16-byte access held in 4, 8 or 16 vectors of registers (the
// register and cluster paths), and the re-reading path with 16-byte or
// one-element access.  The loops over a thread's vectors are unrolled, so
// small menus keep the code small: a block's few warps run it once, mostly
// waiting on instruction fetch.
template <typename T, int ACT>
cudaError_t dispatch_regs(const void* x, const float* s, const float* b,
                          void* out, int S, int N, int HW, int C, int G,
                          float eps, const GnPlan& p, int device,
                          cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
#define NODEMS_GN(V, REGS)                                                  \
  return launch_gn<T, ACT, V, REGS>(x, s, b, out, S, N, HW, C, G, eps, p,   \
                                    device, st)
  if (p.vec == VW) {
    if (p.regs == 0) NODEMS_GN(VW, 0);
    if (p.regs == 4) NODEMS_GN(VW, 4);
    if (p.regs == 8) NODEMS_GN(VW, 8);
    if (p.regs == 16) NODEMS_GN(VW, 16);
  } else if (p.vec == 1 && p.regs == 0) {
    NODEMS_GN(1, 0);
  }
#undef NODEMS_GN
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_act(int act, const void* x, const float* s,
                         const float* b, void* out, int S, int N, int HW,
                         int C, int G, float eps, const GnPlan& p, int device,
                         cudaStream_t st) {
  switch (act) {
    case kActNone:
      return dispatch_regs<T, kActNone>(x, s, b, out, S, N, HW, C, G, eps,
                                        p, device, st);
    case kActRelu:
      return dispatch_regs<T, kActRelu>(x, s, b, out, S, N, HW, C, G, eps,
                                        p, device, st);
    case kActGelu:
      return dispatch_regs<T, kActGelu>(x, s, b, out, S, N, HW, C, G, eps,
                                        p, device, st);
    case kActTanh:
      return dispatch_regs<T, kActTanh>(x, s, b, out, S, N, HW, C, G, eps,
                                        p, device, st);
    case kActSoftsign:
      return dispatch_regs<T, kActSoftsign>(x, s, b, out, S, N, HW, C, G, eps,
                                            p, device, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace nodems

// x, out (S, N, HW, C) contiguous of the dtype; scale, bias (S, C) f32: S
// members of N samples each, sample n of member m normalized with row m
// (S = 1: a single run); the plan as ops/group_norm.py::launch_plan gives
// it.  Returns cudaSuccess or why the launch was refused or failed.
extern "C" int group_norm_act_launch(int dtype, int act, const void* x,
                                     const void* scale, const void* bias,
                                     void* out, int S, int N, int HW, int C,
                                     int G, float eps, int path, int vec,
                                     int warps, int cluster, int regs,
                                     int device, void* stream) {
  using namespace nodems;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const GnPlan p{path, vec, warps, cluster, regs};
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32)
    return dispatch_act<float>(act, x, s, b, out, S, N, HW, C, G, eps, p,
                               device, st);
  if (dtype == NODEMS_BF16)
    return dispatch_act<__nv_bfloat16>(act, x, s, b, out, S, N, HW, C, G,
                                       eps, p, device, st);
  return cudaErrorInvalidValue;
}
