// Kernel B3's shared device code: the launch plan as the kernels see it,
// the thread layout, 16-byte loads and stores, the activations and their
// derivatives, the group sums (warp shuffles or shared memory, over a
// block or a thread-block cluster, always in a fixed order) and the plan's
// checks.  group_norm_act.cu (the forward) and group_norm_act_bwd.cu (the
// backward) each include it and build into their own library.
#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace nodems {

enum Act {
  kActNone = 0,
  kActRelu = 1,
  kActGelu = 2,
  kActTanh = 3,
  kActSoftsign = 4
};

// codes shared with ops/group_norm.py (_PATH_CODES); kGnStaged is the
// backward's only
enum GnPath { kGnRegister = 0, kGnCluster = 1, kGnReread = 2, kGnStaged = 3 };

constexpr int kGnMaxThreads = 256;
constexpr int kGnMaxCluster = 8;  // the portable cluster size

// The launch plan, as ops/group_norm.py::GnPlan gives it.
struct GnPlan {
  int path;     // GnPath; register and cluster take shuffled group sums
  int vec;      // elements a thread reads at once: 16 bytes' worth, or 1
  int warps;    // warps of a CTA (one sample's slice)
  int cluster;  // CTAs per sample
  int regs;     // vectors a thread holds in registers; 0: re-read
  int stash;    // the backward keeps dxhat in shared memory (f32)
};

// How a CTA of `threads` threads covers one pixel's C / vec vector columns:
// P columns side by side, R pixel rows at a time, ncols columns a thread.
struct GnLayout {
  int vpp, P, R, ncols;
};

inline GnLayout gn_layout(int C, int vec, int threads) {
  const int vpp = C / vec;
  if (vpp <= threads) return {vpp, vpp, threads / vpp, 1};
  return {vpp, threads, 1, (vpp + threads - 1) / threads};
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kActRelu) return v < 0.0f ? 0.0f : v;  // NaN passes, as in torch
  if (ACT == kActGelu) return gelu_exact(v);
  if (ACT == kActTanh) return tanhf(v);
  if (ACT == kActSoftsign) return v / (1.0f + fabsf(v));
  return v;
}

// The activation's vector-Jacobian product at its input y: g * act'(y)
// (the JAX custom VJP's dpre; for ReLU the mask y > 0).
template <int ACT>
__device__ __forceinline__ float activate_vjp(float y, float g) {
  if (ACT == kActRelu) return y > 0.0f ? g : 0.0f;
  if (ACT == kActGelu) {
    const float cdf = 0.5f * (1.0f + erff(y * 0.70710678118654752440f));
    const float pdf = 0.39894228040143267794f * expf(-0.5f * y * y);
    return g * fmaf(y, pdf, cdf);
  }
  if (ACT == kActTanh) {
    const float th = tanhf(y);
    return g * (1.0f - th * th);
  }
  if (ACT == kActSoftsign) {
    const float d = 1.0f + fabsf(y);
    return g / (d * d);
  }
  return g;
}

// Loads, stores and f32 views of one access of V elements of T.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // the lower address
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]),
                   bf16x2_bits(f[4], f[5]), bf16x2_bits(f[6], f[7]));
  }
};

template <typename T>
struct Io<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = from_f32<T>(f[0]);
  }
};

// Calls f(kk, j, r, off) for the thread's kk-th vector, at column j, row r,
// element offset off from the thread's first: columns outer, rows inner.
// With REGS > 0 the loop is unrolled, so kk indexes the register array at
// compile time; ONECOL (one column a thread) drops the column bookkeeping.
template <int REGS, bool ONECOL, typename F>
__device__ __forceinline__ void visit(int cnt, int nrows, size_t row_step,
                                      int col_step, F&& f) {
  int j = 0, r = 0;
  size_t col_off = 0, off = 0;
  auto body = [&](int kk) {
    if (ONECOL) {
      f(kk, 0, kk, off);
      off += row_step;
      return;
    }
    f(kk, j, r, off);
    if (++r == nrows) {
      r = 0;
      ++j;
      col_off += col_step;
      off = col_off;
    } else {
      off += row_step;
    }
  };
  if constexpr (REGS > 0) {
#pragma unroll
    for (int kk = 0; kk < REGS; ++kk)
      if (kk < cnt) body(kk);
  } else {
    for (int kk = 0; kk < cnt; ++kk) body(kk);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_index() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The launch's shape and layout, derived on the host from the plan
// (plan_args), so that the kernel divides by nothing on the shuffle path.
struct GnArgs {
  int N, HW, C, G;    // N samples in all
  int warps, k;       // warps of a CTA, CTAs of a sample
  int vpp, P, R;      // gn_layout
  int per;            // pixels of a CTA's slice
  int lg_P, lg_R, lg_cg;  // log2 of powers of two, else -1
  int stash;          // the backward's dxhat in shared memory
  float inv_count, eps;
  int nm = 0;         // samples a member: sample n takes member n / nm's
                      // scale and bias (a fleet's runs; N for one run)
};

// A member-batched launch covers S members of nm samples each, one after
// the other: sample n normalizes with member n / nm's scale and bias, and
// is otherwise the sample a single launch on that member computes.
__device__ __forceinline__ size_t member_offset(int n, const GnArgs& a) {
  return static_cast<size_t>(n / a.nm) * a.C;
}

// Within a thread and across its warp: acc[v], thread t's partial sum of
// channel v of its one column col0, becomes the warp's total over channel
// v's group (shuffle_group_total's first step).  Groups and vector columns
// here are powers of two.  It has no branch: every lane runs every
// butterfly step and keeps the sum only where the step stays within its
// group (a shuffle under a branch costs a divergence check and more time
// than the extra shuffles).
template <int V>
__device__ __forceinline__ void warp_group_sums(float (&acc)[V],
                                                const GnArgs& a) {
  const int cg = 1 << a.lg_cg;
  // within the thread: each channel takes the sum of its group's channels
#pragma unroll
  for (int s = 1; s < V; s <<= 1) {
    float t[V];
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = acc[v] + acc[v ^ s];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = s < cg ? t[v] : acc[v];
  }
  // across the warp: lane bits below vpp pick the column, those above the
  // row; add the group's columns and every row
#pragma unroll
  for (int b = 1; b < 32; b <<= 1) {
    const bool use = b >= a.vpp || b * V < cg;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float o = __shfl_xor_sync(0xffffffffu, acc[v], b);
      acc[v] = use ? acc[v] + o : acc[v];
    }
  }
}

// Shuffled group sums: on return acc[v] is the sample's total over channel
// v's group.  Every thread of the CTA calls it (it may hold barriers).  One
// thread a group adds the warps' sums (and then the cluster's CTAs' in rank
// order, from distributed shared memory) into s_tot, which every thread
// then reads from its own CTA: G * (warps + k) loads a CTA, where each
// thread reading its V groups' partials itself took V * warps (or V * k
// remote ones) and left passes 1 and 2 of the backward's 8-warp clusters
// waiting on distributed shared memory.  A fixed order of adds, so the
// same bits on every launch.
template <int V>
__device__ __forceinline__ void shuffle_group_total(float (&acc)[V],
                                                    const GnArgs& a, int t,
                                                    int col0, float* s_w,
                                                    float* s_cta,
                                                    float* s_tot) {
  warp_group_sums<V>(acc, a);
  if (a.warps * a.k == 1) return;
  // the warps' sums meet in shared memory, [warp][group], written by each
  // warp's first row (lanes of one group write the same value)
  const int W = a.warps;
  if ((t & 31) < a.vpp) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      s_w[(t >> 5) * a.G + ((col0 * V + v) >> a.lg_cg)] = acc[v];
  }
  __syncthreads();
  for (int g = t; g < a.G; g += W * 32) {
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s += s_w[w * a.G + g];
    (a.k == 1 ? s_tot : s_cta)[g] = s;
  }
  if (a.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int g = t; g < a.G; g += W * 32) {
      float s = 0.0f;
      for (int r = 0; r < a.k; ++r) s += cluster.map_shared_rank(s_cta, r)[g];
      s_tot[g] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = s_tot[(col0 * V + v) >> a.lg_cg];
}

// Group sums through shared memory.  s_ch holds every row slot's
// per-channel partials ([R][C]); writes finish(total of group g) to s_out[g]
// for every group.
// s_part is this CTA's partials (read by the cluster).  Every thread calls
// it; it ends with a barrier.
template <typename F>
__device__ __forceinline__ void shared_group_total(const GnArgs& a, int t,
                                                   const float* s_ch,
                                                   float* s_part, float* s_out,
                                                   F&& finish) {
  const int cg = a.C / a.G;
  __syncthreads();
  for (int g = t; g < a.G; g += a.warps * 32) {
    float s = 0.0f;
    for (int r = 0; r < a.R; ++r)
      for (int c = 0; c < cg; ++c) s += s_ch[r * a.C + g * cg + c];
    if (a.k == 1)
      s_out[g] = finish(s);
    else
      s_part[g] = s;
  }
  if (a.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int g = t; g < a.G; g += a.warps * 32) {
      float s = 0.0f;
      for (int r = 0; r < a.k; ++r) s += cluster.map_shared_rank(s_part, r)[g];
      s_out[g] = finish(s);
    }
  }
  __syncthreads();
}

// Bytes of dynamic shared memory the plan needs (ops/group_norm.py::
// _smem_bytes computes the same for launch_plan's checks).
inline long long gn_smem_bytes(const GnPlan& p, const GnLayout& L, int C,
                               int G) {
  if (p.path == kGnReread)
    return 4LL * (static_cast<long long>(L.R) * C + 4LL * G);
  if (p.warps * p.cluster == 1) return 0;
  return 4LL * (2LL * p.warps * G + 3LL * G);
}

// Whether warp shuffles can finish the group sums of this layout: 16-byte
// access, a pixel's vector columns divide a warp, groups align with vectors
// (ops/group_norm.py::access).
inline bool gn_shuffles(const GnLayout& L, int vec, int cg) {
  return vec > 1 && L.vpp <= 32 && 32 % L.vpp == 0 &&
         (vec % cg == 0 || (cg % vec == 0 && L.vpp % (cg / vec) == 0));
}

// The backward's (gn_act_bwd_kernel): on the staged path two mbarriers (16
// bytes) and x's slice of a block (per pixels), with `stash` dxhat's slice
// in f32 (the staged path copies dout into its last plane); then the
// statistics' area (the forward's, always allocated where shuffles sum the
// groups, and there a group's totals [G]) and the sums of pass 3: [2][slots][C]
// (slots: the warps where shuffles add a warp's rows, else the row slots),
// [2][C] by channel and [4][G].
inline long long gn_bwd_smem_bytes(const GnPlan& p, const GnLayout& L, int C,
                                   int G, int per, int elem_bytes,
                                   bool shuffle) {
  const long long slice = static_cast<long long>(per) * C;
  const long long stats = shuffle ? 2LL * p.warps * G + 3LL * G
                                  : static_cast<long long>(L.R) * C + 4LL * G;
  const long long slots = shuffle ? p.warps : L.R;
  return (p.path == kGnStaged ? 16 + slice * elem_bytes : 0) +
         (p.stash ? 4 * slice : 0) +
         4 * (stats + 2 * slots * C + 2LL * C + 4LL * G);
}

inline int log2_exact(int v) {  // -1 unless v is a power of two
  if (v < 1 || (v & (v - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// cudaSuccess if the plan can run on these arguments, else the reason as a
// CUDA error code; fills the kernel's arguments and its shared memory bytes
// (the forward's, or with `bwd` the backward's).
inline cudaError_t plan_args(const GnPlan& p, int elem_bytes, int N, int HW,
                             int C, int G, float eps, const void* x,
                             const void* out, bool bwd, GnArgs* a,
                             long long* smem) {
  if (N < 1 || HW < 1 || C < 1 || G < 1 || C % G != 0)
    return cudaErrorInvalidValue;
  if (p.vec != 1 && p.vec * elem_bytes != 16) return cudaErrorInvalidValue;
  if (C % p.vec != 0) return cudaErrorInvalidValue;
  if (p.vec > 1 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return cudaErrorMisalignedAddress;
  if (log2_exact(p.warps) < 0 || p.warps * 32 > kGnMaxThreads)
    return cudaErrorInvalidConfiguration;
  if (p.cluster < 1 || p.cluster > kGnMaxCluster)
    return cudaErrorInvalidClusterSize;
  const bool resident = p.regs > 0;
  if ((p.path == kGnRegister && !(p.cluster == 1 && resident)) ||
      (p.path == kGnCluster && !(p.cluster > 1 && resident)) ||
      (p.path == kGnReread && resident) ||
      (p.path == kGnStaged && (resident || p.vec == 1 || !bwd)) ||
      p.path < 0 || p.path > 3)
    return cudaErrorInvalidValue;
  // the backward stages or re-reads, and keeps dxhat on chip but where it
  // re-reads a sample too large; the forward has none to keep
  if (bwd ? (p.path == kGnRegister || p.path == kGnCluster ||
             (p.stash == 0 && p.path != kGnReread))
          : p.stash != 0)
    return cudaErrorInvalidValue;
  const GnLayout L = gn_layout(C, p.vec, p.warps * 32);
  const int per = (HW + p.cluster - 1) / p.cluster;
  if (resident &&
      static_cast<long long>((per + L.R - 1) / L.R) * L.ncols > p.regs)
    return cudaErrorInvalidValue;
  const int cg_ = C / G;
  const bool shuffle = gn_shuffles(L, p.vec, cg_);
  // the register and cluster paths finish group sums by shuffles
  if (resident && !shuffle) return cudaErrorInvalidValue;
  *smem = bwd ? gn_bwd_smem_bytes(p, L, C, G, per, elem_bytes,
                                  p.path == kGnStaged && shuffle)
              : gn_smem_bytes(p, L, C, G);
  *a = GnArgs{N,
              HW,
              C,
              G,
              p.warps,
              p.cluster,
              L.vpp,
              L.P,
              L.R,
              per,
              log2_exact(L.P),
              log2_exact(L.R),
              log2_exact(cg_),
              p.stash,
              1.0f / (static_cast<float>(HW) * static_cast<float>(cg_)),
              eps};
  return cudaSuccess;
}

// The device's opt-in shared memory per block, read once per device, and
// the instance allowed all of it on first use (only plans above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, int device, long long bytes,
                       std::atomic<int>* allowed) {
  static std::atomic<int> limit[kMaxDevices];  // 0: not read yet
  int v = limit[device].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    limit[device].store(v, std::memory_order_relaxed);
  }
  if (bytes > v) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024 && !allowed[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (err != cudaSuccess) return err;
    allowed[device].store(1, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace nodems
