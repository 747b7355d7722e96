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
//   the warps' sums through shared memory.
// - Re-reading path: every other layout (group sums that shuffles cannot
//   finish, one-element access) and slices too large even for 8 CTAs.  The
//   same CTA or cluster layout, but each pass reads its slice again (mostly
//   from L1 or L2), and each thread writes per-channel partials to shared
//   memory, where one thread a group adds them.  Either way the order of
//   every sum is fixed.
// The normalize pass applies (x - mean) * (rstd * scale) + bias and the
// activation in f32 and rounds once to T, with 16-byte stores.
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

// codes shared with ops/group_norm.py (_PATH_CODES)
enum GnPath { kGnRegister = 0, kGnCluster = 1, kGnReread = 2 };

constexpr int kGnMaxThreads = 256;
constexpr int kGnMaxCluster = 8;  // the portable cluster size

// The launch plan, as ops/group_norm.py::GnPlan gives it.
struct GnPlan {
  int path;     // GnPath; register and cluster take shuffled group sums
  int vec;      // elements a thread reads at once: 16 bytes' worth, or 1
  int warps;    // warps of a CTA (one sample's slice)
  int cluster;  // CTAs per sample
  int regs;     // vectors a thread holds in registers; 0: re-read
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
  int N, HW, C, G;
  int warps, k;       // warps of a CTA, CTAs of a sample
  int vpp, P, R;      // gn_layout
  int per;            // pixels of a CTA's slice
  int lg_P, lg_R, lg_cg;  // log2 of powers of two, else -1
  float inv_count, eps;
};

// Shuffled group sums.  acc[v] is thread t's partial sum of channel v of its
// one column col0; on return acc[v] is the sample's total over channel v's
// group.  Every thread of the CTA calls it (it may hold barriers).  Groups
// and vector columns here are powers of two.  It has no branch: every lane
// runs every butterfly step and keeps the sum only where the step stays
// within its group (a shuffle under a branch costs a divergence check and
// more time than the extra shuffles).
template <int V>
__device__ __forceinline__ void shuffle_group_total(float (&acc)[V],
                                                    const GnArgs& a, int t,
                                                    int col0, float* s_w,
                                                    float* s_cta) {
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
  if (a.k == 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* p = s_w + ((col0 * V + v) >> a.lg_cg);
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kGnMaxThreads / 32; ++w)
        if (w < W) s += p[w * a.G];
      acc[v] = s;
    }
    return;
  }
  // this CTA's sums, then every CTA adds the cluster's in rank order
  for (int g = t; g < a.G; g += W * 32) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kGnMaxThreads / 32; ++w)
      if (w < W) s += s_w[w * a.G + g];
    s_cta[g] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int g = (col0 * V + v) >> a.lg_cg;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kGnMaxCluster; ++r)
      if (r < a.k) s += cluster.map_shared_rank(s_cta, r)[g];
    acc[v] = s;
  }
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

  // shared memory: SHUFFLE [2][warps][G] then the cluster's [2][G]; else
  // [R][C] then [4][G]
  float* s_w1 = smem;
  float* s_w2 = s_w1 + a.warps * a.G;
  float* s_cta1 = s_w2 + a.warps * a.G;
  float* s_cta2 = s_cta1 + a.G;
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
    shuffle_group_total<V>(acc, a, t, col0, s_w1, s_cta1);
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
    shuffle_group_total<V>(acc, a, t, col0, s_w2, s_cta2);
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

// Bytes of dynamic shared memory the plan needs (ops/group_norm.py::
// _smem_bytes computes the same for launch_plan's checks).
inline long long gn_smem_bytes(const GnPlan& p, const GnLayout& L, int C,
                               int G) {
  if (p.path == kGnReread)
    return 4LL * (static_cast<long long>(L.R) * C + 4LL * G);
  if (p.warps * p.cluster == 1) return 0;
  return 4LL * (2LL * p.warps * G + (p.cluster > 1 ? 2LL * G : 0));
}

inline int log2_exact(int v) {  // -1 unless v is a power of two
  if (v < 1 || (v & (v - 1)) != 0) return -1;
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// cudaSuccess if the plan can run on these arguments, else the reason as a
// CUDA error code; fills the kernel's arguments and its shared memory bytes.
inline cudaError_t plan_args(const GnPlan& p, int elem_bytes, int N, int HW,
                             int C, int G, float eps, const void* x,
                             const void* out, GnArgs* a, long long* smem) {
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
      (p.path == kGnReread && resident) || p.path < 0 || p.path > 2)
    return cudaErrorInvalidValue;
  const GnLayout L = gn_layout(C, p.vec, p.warps * 32);
  const int per = (HW + p.cluster - 1) / p.cluster;
  if (resident &&
      static_cast<long long>((per + L.R - 1) / L.R) * L.ncols > p.regs)
    return cudaErrorInvalidValue;
  const int cg_ = C / G;
  // the register and cluster paths finish group sums by shuffles
  if (resident && !(L.vpp <= 32 && 32 % L.vpp == 0 &&
                    (p.vec % cg_ == 0 ||
                     (cg_ % p.vec == 0 && L.vpp % (cg_ / p.vec) == 0))))
    return cudaErrorInvalidValue;
  *smem = gn_smem_bytes(p, L, C, G);
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

template <typename T, int ACT, int V, int REGS>
cudaError_t launch_gn(const void* x, const float* scale, const float* bias,
                      void* out, int N, int HW, int C, int G, float eps,
                      const GnPlan& p, int device, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  auto kernel = gn_act_kernel<T, ACT, V, REGS>;
  GnArgs a;
  long long smem = 0;
  cudaError_t err =
      plan_args(p, sizeof(T), N, HW, C, G, eps, x, out, &a, &smem);
  if (err != cudaSuccess) return err;
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
                          void* out, int N, int HW, int C, int G, float eps,
                          const GnPlan& p, int device, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
#define NODEMS_GN(V, REGS)                                                  \
  return launch_gn<T, ACT, V, REGS>(x, s, b, out, N, HW, C, G, eps, p,      \
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
                         const float* b, void* out, int N, int HW, int C,
                         int G, float eps, const GnPlan& p, int device,
                         cudaStream_t st) {
  switch (act) {
    case kActNone:
      return dispatch_regs<T, kActNone>(x, s, b, out, N, HW, C, G, eps, p,
                                        device, st);
    case kActRelu:
      return dispatch_regs<T, kActRelu>(x, s, b, out, N, HW, C, G, eps, p,
                                        device, st);
    case kActGelu:
      return dispatch_regs<T, kActGelu>(x, s, b, out, N, HW, C, G, eps, p,
                                        device, st);
    case kActTanh:
      return dispatch_regs<T, kActTanh>(x, s, b, out, N, HW, C, G, eps, p,
                                        device, st);
    case kActSoftsign:
      return dispatch_regs<T, kActSoftsign>(x, s, b, out, N, HW, C, G, eps, p,
                                            device, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace nodems

// x, out (N, HW, C) contiguous of the dtype; scale, bias (C,) f32; the plan
// as ops/group_norm.py::launch_plan gives it.  Returns cudaSuccess or why
// the launch was refused or failed.
extern "C" int group_norm_act_launch(int dtype, int act, const void* x,
                                     const void* scale, const void* bias,
                                     void* out, int N, int HW, int C, int G,
                                     float eps, int path, int vec, int warps,
                                     int cluster, int regs, int device,
                                     void* stream) {
  using namespace nodems;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const GnPlan p{path, vec, warps, cluster, regs};
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32)
    return dispatch_act<float>(act, x, s, b, out, N, HW, C, G, eps, p, device,
                               st);
  if (dtype == NODEMS_BF16)
    return dispatch_act<__nv_bfloat16>(act, x, s, b, out, N, HW, C, G, eps, p,
                                       device, st);
  return cudaErrorInvalidValue;
}
