// Kernel B3's backward: the vector-Jacobian product of GroupNorm (eps, f32
// affine) + activation over NHWC.
//
// Replaces the custom VJP of neural_ode_metasolver_tpu/ops/pallas_kernels.py
// ::fused_group_norm_act (_bwd), which is jnp there, not Pallas: recompute
// the two-pass f32 mean and rstd of each (sample, group), xhat and
// y = xhat * scale + bias; dpre = act'(y) * dout; dscale = sum over N, H, W
// of dpre * xhat and dbias = sum of dpre; and
//   dx = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat)),
// dxhat = dpre * scale, rounded once to x's dtype.
//
// Bound on the H100: bytes.  It reads x and dout and writes dx (3 * N*H*W*C
// * sizeof(T)) against about 30 f32 operations an element, and the exact
// GELU's derivative (an erf and an exp) where the forward fused it.  At
// (256, 32, 32, 64) bf16, at 3.35 TB/s: 30 us.
//
// Design: the forward's thread layout (group_norm_act.cuh), one block or one
// thread-block cluster a sample, and the launch plan of
// ops/group_norm.py::launch_plan(..., backward=True).  act' is evaluated
// once an element: pass 3 keeps dxhat in f32 in shared memory (the stash)
// and pass 4 reads it back, so it runs no transcendental.  Each thread reads
// back only the vectors it wrote, so the stash needs no barrier.  Paths:
// - staged (every layout with 16-byte access whose slice fits two blocks an
//   SM, over at most 8 blocks): one thread copies the block's slice of x and
//   of dout, each one contiguous NHWC span, into shared memory with a 1-D
//   bulk copy (TMA, no tensor map) on its own mbarrier; dout lands in the
//   stash's last plane, where dxhat overwrites it, so bf16 needs 6 bytes an
//   element and f32 8.  The threads keep nothing in registers across passes
//   but their columns' constants (at most 128 registers), so two blocks run
//   on an SM, and the copy of dout completes behind passes 1 and 2;
// - re-reading: x and dout read again in each pass, the stash kept where it
//   fits a block (else pass 4 evaluates act' again): samples too large for 8
//   staged blocks, and layouts without 16-byte access.
// Measured alternatives and the plan's rule: PERF.md.
// Four passes:
//   1. the group means, 2. the centred squares, as in the forward (shuffled
//      or shared-memory group sums, the cluster's in rank order);
//   3. per channel, A = sum of dpre * xhat and B = sum of dpre over the
//      thread's pixels, added over a warp's rows by shuffles (or written by
//      row slot), then over the warps (row slots) in order: the block's
//      per-channel sums.  With `part` the block writes them there (dscale
//      and dbias partials, one row per block).  The group sums of dxhat and
//      dxhat * xhat are then sum over the group's channels of scale * B and
//      scale * A, added over the cluster's blocks in rank order;
//   4. dx = rstd * (dxhat - mean_g(dxhat) - xhat * mean_g(dxhat * xhat)),
//      16-byte stores.
// A second kernel adds the partials' rows (N * cluster of them) in a fixed
// order: no float atomics anywhere, so two launches give the same bits.
// A member-batched launch (a fleet's S runs, sample n of member n / N)
// adds each member's own rows into its own row of dscale and dbias.
// The attack's backward needs dx only and passes no `part`.
#include "group_norm_act.cuh"

namespace nodems {

// dxhat of vector q of a block's slice (nvec vectors) in the stash: V / 4
// planes of float4 (so neighbouring threads touch neighbouring 16 bytes and
// a plane matches a 16-byte vector of bf16 or f32), or V floats (V = 1).
template <int V>
__device__ __forceinline__ void stash_put(float* s, int nvec, int q,
                                          const float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h)
      reinterpret_cast<float4*>(s)[h * nvec + q] =
          make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) s[q * V + v] = f[v];
  }
}

template <int V>
__device__ __forceinline__ void stash_get(const float* s, int nvec, int q,
                                          float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 u = reinterpret_cast<const float4*>(s)[h * nvec + q];
      f[4 * h] = u.x;
      f[4 * h + 1] = u.y;
      f[4 * h + 2] = u.z;
      f[4 * h + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = s[q * V + v];
  }
}

// STAGED: x and dout in shared memory; else re-read.  SHUFFLE: one column
// a thread, group sums by shuffles (the staged path, where the layout
// allows).
template <typename T, int ACT, int V, bool STAGED, bool SHUFFLE>
__global__ void __launch_bounds__(kGnMaxThreads, STAGED ? 2 : 1)
gn_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ dx,
                  float* __restrict__ part, const GnArgs a) {
  static_assert(!STAGED || V * sizeof(T) == 16,
                "the staged path reads 16-byte vectors from shared memory");
  static_assert(STAGED || !SHUFFLE, "re-reading sums in shared memory");
  using IO = Io<T, V>;
  using Raw = typename IO::Raw;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int t = static_cast<int>(threadIdx.x);
  const int rank = a.k > 1 ? cluster_rank() : 0;
  const int n = a.k > 1 ? cluster_index() : static_cast<int>(blockIdx.x);
  scale += member_offset(n, a);
  bias += member_offset(n, a);
  const int col0 = SHUFFLE ? t & (a.P - 1) : t % a.P;
  const int row0 = SHUFFLE ? t >> a.lg_P : t / a.P;
  const int W = a.warps;

  // this block's slice of the sample: pixels [p0, p0 + npx)
  const int p0 = min(a.HW, rank * a.per);
  const int npx = min(a.HW, p0 + a.per) - p0;
  const bool owner = row0 < a.R;  // holds a row slot
  int nrows = 0;
  if (owner && row0 < npx)
    nrows = SHUFFLE ? (npx - row0 + a.R - 1) >> a.lg_R
                    : (npx - row0 + a.R - 1) / a.R;
  const int ncols = SHUFFLE ? 1 : (owner ? (a.vpp - col0 + a.P - 1) / a.P : 0);
  const int cnt = nrows * ncols;
  const size_t base = (static_cast<size_t>(n) * a.HW + p0) * a.C;
  // the thread's first element within the block's slice
  const int loc0 = row0 * a.C + col0 * V;
  const T* xs = x + base + loc0;
  const T* gs = dout + base + loc0;
  T* os = dx + base + loc0;
  const size_t row_step = static_cast<size_t>(a.R) * a.C;
  const int col_step = a.P * V;
  // vector q of the slice: the thread's element offset `off`, over V
  auto vec_of = [&](size_t off) {
    return static_cast<int>((static_cast<unsigned>(loc0) +
                             static_cast<unsigned>(off)) / V);
  };

  // shared memory (gn_bwd_smem_bytes): STAGED, two mbarriers and x's slice;
  // with a.stash, dxhat's slice in f32 (STAGED copies dout into its last
  // plane); then the statistics' area, SHUFFLE [2][warps][G], the
  // cluster's [2][G] and the totals [G], else [R][C] then [4][G]; then
  // pass 3's [2][slots][C], [2][C] and [4][G]
  const int nvec = a.per * a.vpp;
  unsigned char* sp = smem_raw;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sp);
  const T* x_s = reinterpret_cast<const T*>(sp + 16);
  if (STAGED) sp += 16 + static_cast<size_t>(a.per) * a.C * sizeof(T);
  float* stash = reinterpret_cast<float*>(sp);
  const float* g_s = stash + (V >= 4 ? (V / 4 - 1) * 4 * nvec : 0);
  if (a.stash) sp += static_cast<size_t>(nvec) * V * sizeof(float);
  float* smem = reinterpret_cast<float*>(sp);
  const int slots = SHUFFLE ? W : a.R;
  float* s_w1 = smem;
  float* s_w2 = s_w1 + W * a.G;
  float* s_cta1 = s_w2 + W * a.G;
  float* s_cta2 = s_cta1 + a.G;
  float* s_tot = s_cta2 + a.G;
  float* s_ch = smem;
  float* s_part1 = s_ch + a.R * a.C;
  float* s_part2 = s_part1 + a.G;
  float* s_mean = s_part2 + a.G;
  float* s_rstd = s_mean + a.G;
  float* s_a = smem + (SHUFFLE ? 2 * W * a.G + 3 * a.G : a.R * a.C + 4 * a.G);
  float* s_b = s_a + slots * a.C;
  float* s_ca = s_b + slots * a.C;  // scale * A of the block, by channel
  float* s_cb = s_ca + a.C;         // scale * B
  float* s_p1 = s_cb + a.C;         // the block's group sums (the cluster's)
  float* s_p2 = s_p1 + a.G;
  float* s_m1 = s_p2 + a.G;  // mean over the group of dxhat
  float* s_m2 = s_m1 + a.G;  // mean over the group of dxhat * xhat

  if constexpr (STAGED) {
    // one thread copies the slice of x and of dout, each on its barrier
    const uint32_t bx = smem_u32(bars), bg = smem_u32(bars + 1);
    if (t == 0) {
      mbar_init(bx, 1);
      mbar_init(bg, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
      const uint32_t bytes =
          static_cast<uint32_t>(npx) * a.C * static_cast<uint32_t>(sizeof(T));
      mbar_expect_tx(bx, bytes);
      if (bytes) bulk_load(smem_u32(x_s), x + base, bytes, bx);
      mbar_expect_tx(bg, bytes);
      if (bytes) bulk_load(smem_u32(g_s), dout + base, bytes, bg);
    }
    mbar_wait(bx, 0);
  }

  // the current column's statistics, scale and bias (SHUFFLE: of its one
  // column)
  float mch[V], rch[V], sc[V], bi[V], m1[V], m2[V];
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
  // a column's partial sums are done: to row slot row0 of `dst` ([R][C])
  auto flush = [&](float* dst, int j, float (&acc)[V]) {
    float* p = dst + row0 * a.C + (col0 + j * a.P) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = acc[v];
      acc[v] = 0.0f;
    }
  };

  auto get_x = [&](size_t off) -> Raw {
    if constexpr (STAGED)
      return *reinterpret_cast<const Raw*>(x_s + loc0 + off);
    return IO::load(xs + off);
  };
  auto get_g = [&](size_t off) -> Raw {
    if constexpr (STAGED)
      return *reinterpret_cast<const Raw*>(g_s + 4 * vec_of(off));
    return IO::load(gs + off);
  };
  auto walk = [&](auto&& f) {
    visit<0, SHUFFLE>(cnt, nrows, row_step, col_step, f);
  };

  // pass 1: the sum of each of the thread's channels over its rows
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (!SHUFFLE && owner && nrows == 0)
    for (int j = 0; j < ncols; ++j) flush(s_ch, j, acc);
  walk([&](int, int j, int r, size_t off) {
    float f[V];
    IO::unpack(get_x(off), f);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += f[v];
    if (!SHUFFLE && r == nrows - 1) flush(s_ch, j, acc);
  });
  if constexpr (SHUFFLE) {
    shuffle_group_total<V>(acc, a, t, col0, s_w1, s_cta1, s_tot);
#pragma unroll
    for (int v = 0; v < V; ++v) mch[v] = acc[v] * a.inv_count;
  } else {
    shared_group_total(a, t, s_ch, s_part1, s_mean,
                       [&](float s) { return s * a.inv_count; });
  }

  // pass 2: centred squares
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (!SHUFFLE && owner && nrows == 0)
    for (int j = 0; j < ncols; ++j) flush(s_ch, j, acc);
  walk([&](int, int j, int r, size_t off) {
    if (!SHUFFLE && r == 0) column_stats(j, s_mean, mch);
    float f[V];
    IO::unpack(get_x(off), f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - mch[v];
      acc[v] = fmaf(d, d, acc[v]);
    }
    if (!SHUFFLE && r == nrows - 1) flush(s_ch, j, acc);
  });
  if constexpr (SHUFFLE) {
    shuffle_group_total<V>(acc, a, t, col0, s_w2, s_cta2, s_tot);
#pragma unroll
    for (int v = 0; v < V; ++v)
      rch[v] = rsqrtf(fmaf(acc[v], a.inv_count, a.eps));
  } else {
    shared_group_total(a, t, s_ch, s_part2, s_rstd, [&](float q) {
      return rsqrtf(fmaf(q, a.inv_count, a.eps));
    });
  }

  // pass 3: A = sum of dpre * xhat and B = sum of dpre, per channel; dxhat
  // to the stash
  if constexpr (STAGED) mbar_wait(smem_u32(bars + 1), 0);
  if (SHUFFLE && cnt > 0) column_affine(0);
  float sa[V], sb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sa[v] = sb[v] = 0.0f;
  auto load_column = [&](int j) {  // !SHUFFLE: a new column's constants
    column_stats(j, s_mean, mch);
    column_stats(j, s_rstd, rch);
    column_affine(j);
  };
  if (!SHUFFLE && owner && nrows == 0)
    for (int j = 0; j < ncols; ++j) {
      flush(s_a, j, sa);
      flush(s_b, j, sb);
    }
  walk([&](int, int j, int r, size_t off) {
    if (!SHUFFLE && r == 0) load_column(j);
    float f[V], g[V];
    IO::unpack(get_x(off), f);
    IO::unpack(get_g(off), g);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = (f[v] - mch[v]) * rch[v];
      const float dp = activate_vjp<ACT>(fmaf(xh, sc[v], bi[v]), g[v]);
      sa[v] = fmaf(dp, xh, sa[v]);
      sb[v] += dp;
      g[v] = dp * sc[v];  // dxhat
    }
    if (a.stash) stash_put<V>(stash, nvec, vec_of(off), g);
    if (!SHUFFLE && r == nrows - 1) {
      flush(s_a, j, sa);
      flush(s_b, j, sb);
    }
  });
  if constexpr (SHUFFLE) {
    // a warp's rows (lanes vpp apart hold one column) by shuffles, in a
    // fixed order; lanes below vpp write the warp's row of [warps][C]
    for (int b = a.vpp; b < 32; b <<= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sa[v] += __shfl_xor_sync(0xffffffffu, sa[v], b);
        sb[v] += __shfl_xor_sync(0xffffffffu, sb[v], b);
      }
    }
    if ((t & 31) < a.vpp) {
      float* pa = s_a + (t >> 5) * a.C + col0 * V;
      float* pb = s_b + (t >> 5) * a.C + col0 * V;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        pa[v] = sa[v];
        pb[v] = sb[v];
      }
    }
  }
  __syncthreads();
  // the block's per-channel sums: warps (row slots) added in order
  for (int c = t; c < a.C; c += W * 32) {
    float ca = 0.0f, cb = 0.0f;
    for (int r = 0; r < slots; ++r) {
      ca += s_a[r * a.C + c];
      cb += s_b[r * a.C + c];
    }
    if (part != nullptr) {
      float* p = part + (static_cast<size_t>(n) * a.k + rank) * 2 * a.C;
      p[c] = ca;
      p[a.C + c] = cb;
    }
    const float s = __ldg(scale + c);
    s_ca[c] = s * ca;
    s_cb[c] = s * cb;
  }
  __syncthreads();
  // the group sums of dxhat and dxhat * xhat, the cluster's in rank order
  const int cgs = a.C / a.G;
  for (int g = t; g < a.G; g += W * 32) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = 0; c < cgs; ++c) {
      s1 += s_cb[g * cgs + c];
      s2 += s_ca[g * cgs + c];
    }
    if (a.k == 1) {
      s_m1[g] = s1 * a.inv_count;
      s_m2[g] = s2 * a.inv_count;
    } else {
      s_p1[g] = s1;
      s_p2[g] = s2;
    }
  }
  if (a.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int g = t; g < a.G; g += W * 32) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int r = 0; r < a.k; ++r) {
        s1 += cluster.map_shared_rank(s_p1, r)[g];
        s2 += cluster.map_shared_rank(s_p2, r)[g];
      }
      s_m1[g] = s1 * a.inv_count;
      s_m2[g] = s2 * a.inv_count;
    }
  }
  __syncthreads();
  // no block may leave while another still reads its shared memory
  if (a.k > 1) cluster_arrive();

  // pass 4: dx from x and the stash (or dxhat again where there is no
  // stash), rounded once, 16-byte stores
  if (SHUFFLE && cnt > 0) {
    column_stats(0, s_m1, m1);
    column_stats(0, s_m2, m2);
  }
  walk([&](int, int j, int r, size_t off) {
    if (!SHUFFLE && r == 0) {
      load_column(j);
      column_stats(j, s_m1, m1);
      column_stats(j, s_m2, m2);
    }
    float f[V], d[V];
    IO::unpack(get_x(off), f);
    if (a.stash) {
      stash_get<V>(stash, nvec, vec_of(off), d);
    } else {
      IO::unpack(get_g(off), d);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (f[v] - mch[v]) * rch[v];
        d[v] = activate_vjp<ACT>(fmaf(xh, sc[v], bi[v]), d[v]) * sc[v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = (f[v] - mch[v]) * rch[v];
      f[v] = rch[v] * (d[v] - m1[v] - xh * m2[v]);
    }
    IO::store(os + off, f);
  });
  if (a.k > 1) cluster_wait();
}

// dscale and dbias: the partials' rows (one a block) added in row order.
// A block takes 32 of the 2C columns ([dscale | dbias]); its 32 warps each
// add every 32nd row, then one warp adds the 32 sums in order.  Member
// blockIdx.y adds its own `rows` rows into its own row of dscale and dbias.
__global__ void __launch_bounds__(1024)
gn_param_grad_reduce(const float* __restrict__ part, int rows, int C,
                     float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float s[32][33];
  const size_t m = blockIdx.y;
  part += m * rows * 2 * static_cast<size_t>(C);
  dscale += m * C;
  dbias += m * C;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int slot = static_cast<int>(threadIdx.x) >> 5;
  const int col = static_cast<int>(blockIdx.x) * 32 + lane;
  const int width = 2 * C;
  float acc = 0.0f;
  if (col < width)
    for (int r = slot; r < rows; r += 32)
      acc += part[static_cast<size_t>(r) * width + col];
  s[slot][lane] = acc;
  __syncthreads();
  if (slot == 0 && col < width) {
    float tot = 0.0f;
    for (int i = 0; i < 32; ++i) tot += s[i][lane];
    if (col < C)
      dscale[col] = tot;
    else
      dbias[col - C] = tot;
  }
}

template <typename T, int ACT, int V, bool STAGED, bool SHUFFLE>
cudaError_t launch_gn_bwd(const void* x, const void* dout, const float* scale,
                          const float* bias, void* dx, float* part,
                          float* dscale, float* dbias, int S, int N, int HW,
                          int C, int G, float eps, const GnPlan& p,
                          int device, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  auto kernel = gn_act_bwd_kernel<T, ACT, V, STAGED, SHUFFLE>;
  GnArgs a;
  long long smem = 0;
  if (S < 1 || S > 65535 || N < 1 ||
      static_cast<long long>(S) * N * p.cluster >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaError_t err =
      plan_args(p, sizeof(T), S * N, HW, C, G, eps, x, dx, true, &a, &smem);
  if (err != cudaSuccess) return err;
  a.nm = N;
  const int rows = N * p.cluster;  // partial rows a member
  N *= S;
  if (p.vec > 1 && reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if ((part == nullptr) != (dscale == nullptr) ||
      (part == nullptr) != (dbias == nullptr))
    return cudaErrorInvalidValue;
  err = allow_smem(kernel, device, smem, allowed);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dout);
  T* dt = static_cast<T*>(dx);
  const unsigned threads = p.warps * 32;
  if (p.cluster == 1) {
    kernel<<<N, threads, smem, stream>>>(xt, gt, scale, bias, dt, part, a);
  } else {
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
    err = cudaLaunchKernelEx(&cfg, kernel, xt, gt, scale, bias, dt, part, a);
    if (err != cudaSuccess) return err;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  gn_param_grad_reduce<<<dim3((2 * C + 31) / 32, S), 1024, 0, stream>>>(
      part, rows, C, dscale, dbias);
  return cudaGetLastError();
}

// The instances: with 16-byte access the staged path (with or without
// shuffled sums) and re-reading, with one element re-reading.
template <typename T, int ACT>
cudaError_t dispatch_bwd_path(const void* x, const void* g, const float* s,
                              const float* b, void* dx, float* part,
                              float* ds, float* db, int S, int N, int HW,
                              int C, int G, float eps, const GnPlan& p,
                              int device, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
#define NODEMS_GN_BWD(V, STAGED, SHUFFLE)                                  \
  return launch_gn_bwd<T, ACT, V, STAGED, SHUFFLE>(                        \
      x, g, s, b, dx, part, ds, db, S, N, HW, C, G, eps, p, device, st)
  if (p.vec == VW && p.path == kGnStaged) {
    // plan_args refuses what this does not vet
    if (C > 0 && G > 0 && C % G == 0 && C % VW == 0 && p.warps > 0 &&
        gn_shuffles(gn_layout(C, VW, p.warps * 32), VW, C / G))
      NODEMS_GN_BWD(VW, true, true);
    NODEMS_GN_BWD(VW, true, false);
  }
  if (p.path == kGnReread) {
    if (p.vec == VW) NODEMS_GN_BWD(VW, false, false);
    if (p.vec == 1) NODEMS_GN_BWD(1, false, false);
  }
#undef NODEMS_GN_BWD
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bwd_act(int act, const void* x, const void* g,
                             const float* s, const float* b, void* dx,
                             float* part, float* ds, float* db, int S, int N,
                             int HW, int C, int G, float eps, const GnPlan& p,
                             int device, cudaStream_t st) {
#define NODEMS_GN_BWD_ACT(A)                                                \
  return dispatch_bwd_path<T, A>(x, g, s, b, dx, part, ds, db, S, N, HW, C, \
                                 G, eps, p, device, st)
  switch (act) {
    case kActNone:
      NODEMS_GN_BWD_ACT(kActNone);
    case kActRelu:
      NODEMS_GN_BWD_ACT(kActRelu);
    case kActGelu:
      NODEMS_GN_BWD_ACT(kActGelu);
    case kActTanh:
      NODEMS_GN_BWD_ACT(kActTanh);
    case kActSoftsign:
      NODEMS_GN_BWD_ACT(kActSoftsign);
  }
#undef NODEMS_GN_BWD_ACT
  return cudaErrorInvalidValue;
}

}  // namespace nodems

// x, dout, dx (S, N, HW, C) contiguous of the dtype; scale, bias (S, C)
// f32: S members of N samples each, member m's samples normalized with row
// m (S = 1: a single run); the plan (path, vec, warps, cluster, regs,
// stash) as ops/group_norm.py::launch_plan(..., backward=True) gives it.
// With part (S * N * cluster, 2, C) f32 scratch, also dscale and dbias
// (S, C) f32, each member's row summed over its own samples only, in a
// single run's order; with part, dscale and dbias null, dx only.  Returns
// cudaSuccess or why the launch was refused or failed.
extern "C" int group_norm_act_bwd_launch(int dtype, int act, const void* x,
                                         const void* dout, const void* scale,
                                         const void* bias, void* dx,
                                         void* part, void* dscale,
                                         void* dbias, int S, int N, int HW,
                                         int C, int G, float eps, int path,
                                         int vec, int warps, int cluster,
                                         int regs, int stash, int device,
                                         void* stream) {
  using namespace nodems;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const GnPlan p{path, vec, warps, cluster, regs, stash};
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NODEMS_F32)
    return dispatch_bwd_act<float>(act, x, dout, s, b, dx, pt, ds, db, S, N,
                                   HW, C, G, eps, p, device, st);
  if (dtype == NODEMS_BF16)
    return dispatch_bwd_act<__nv_bfloat16>(act, x, dout, s, b, dx, pt, ds, db,
                                           S, N, HW, C, G, eps, p, device,
                                           st);
  return cudaErrorInvalidValue;
}
