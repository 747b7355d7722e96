// Implicit-GEMM 3x3 stride-1 SAME convolution for sm_90a, shared by kernel
// B1 (conv3x3.cu) and kernel B2 (ode_block_rk2.cu).
//
// Layouts are the JAX package's: x (N, H, W, Cin) NHWC, w (3, 3, Cin, Cout)
// HWIO, outputs (N, H, W, Cout) NHWC, all contiguous.  The kernels here are
// bf16 (every sum kept in f32); the helpers and epilogues serve the f32
// core of conv3x3_f32.cuh too.
//
// The GEMM is the one the TPU kernel ran (pallas_im2col.py:43-54,93-103):
//   M = N*H*W output pixels, flattened across images (a 6x6 image wastes no
//       tile rows), N = Cout, K = 9*Cin ordered (tap, channel), which is
//       HWIO reshaped to (9*Cin, Cout): the weights are read as they lie.
// A fleet of S runs (S members, each N images and its own weights) is one
// launch: grid dimension z is the member (to_member), M is counted per
// member, and each member's blocks are a single launch's.
// The 9x patch matrix is never formed in device memory.  A K step is 64
// bf16 channels (one 128-byte row of A per pixel) of one tap.  B tiles (BK
// x BN) stream through a ring of STAGES slots in dynamic shared memory, in
// panels of 128-byte rows; every tile is 16-byte chunks XOR-swizzled by row
// (chunk ^ (row & 7)), which is wgmma's 128-byte swizzle and keeps ldmatrix
// free of bank conflicts.  Each K step waits on one cp.async group and one
// __syncthreads, then issues the copies of a later step.  Three bf16
// kernels (conv_path picks one):
//
// conv3x3_halo_kernel (bf16, Cin a multiple of 64, Cout of 8 and at least
//   16: every conv of B2 and premetanode10's B1 but the stem).  The source
//   pixels of a block's BM output pixels under all nine taps are the
//   contiguous pixels m0-W-1 .. m0+BM+W; each 64-channel chunk of them is
//   copied once by 16-byte cp.async.cg, and ldmatrix gathers each tap's A fragments from
//   it, one row address per lane, a zero row where the source pixel lies
//   outside the image (the SAME padding).  wgmma.mma_async m64nBNk16 takes
//   A from registers and B from shared memory, f32 accumulate.
// conv3x3_halo_narrow_kernel (bf16, Cin a multiple of 64, Cout under 16:
//   the stem's 64 -> 3 dgrad): the same halo and A, an N tile of 8 or 16
//   with B K-major, copied element by element (zero past Cout); kStore only.
// conv3x3_igemm_kernel (bf16: the stem's Cin 3, Cin 65, halos too wide for
//   shared memory): each K step gathers its A tile (BM shifted pixel rows)
//   into the ring beside B, 16-byte cp.async.cg where Cin is a multiple of
//   64, else element by element through registers (K = 9*Cin walked flat,
//   zero past K, past Cout and outside the image); wgmma reads A and B from
//   shared memory.
// Every f32 conv runs conv3x3_f32.cuh's core, on a plan the wrappers pass.
//
// Bound on the H100 at the serving shapes: 2*9*Cin*Cout flops per pixel
// against 2*(Cin + Cout) bytes in bf16; at Cin = Cout = 64 that sits at the
// card's bf16 ridge (0.020 ms for a (256,32,32,64->64) conv), the stem is
// bound by its output bytes.
//
// Epilogues (template switch EPI), per output element o with f32 sum s;
// every rounding point is the Pallas kernels':
//   kStore   out[o] = T(s)
//   kGelu    out[o] = T(gelu(T(s)))
//   kStage1  k1[o] = s (f32);  out[o] = T(gelu(T(y[o] + a*s)))
//   kStage2  v = T(y[o] + a*(b1*k1[o] + b2*s));  out[o] = v;
//            aux[o] = T(gelu(v)) unless aux is null.  May run in place
//            (out == y): each element is read, then written, by one thread.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace nodems {

enum Epilogue { kStore = 0, kGelu = 1, kStage1 = 2, kStage2 = 3 };

struct ConvArgs {
  const void* x;  // (S, N, H, W, Cin)
  const void* w;  // (S, 3, 3, Cin, Cout)
  void* out;      // (S, N, H, W, Cout)
  const void* y;  // kStage1/kStage2: the RK state (may alias out)
  float* k1;      // kStage1 writes it, kStage2 reads it
  void* aux;      // kStage2: gelu of the new state, or null
  int N, H, W, Cin, Cout;  // N images a member
  float a, b1, b2;
  int S = 1;  // members: a fleet's runs, each its own images and weights
  int ldw = 0;  // w's row stride in elements (f32 core only), 0: Cout
};

// A member-batched launch: grid dimension z is the member.  Member m's
// blocks run exactly the blocks of a single launch on member m's images
// and weights (the same tiles, the same sums in the same order), so its
// output is bit-equal to that launch's; M = N*H*W is counted per member,
// and no tile straddles two members.  A single run is member 0.
template <typename T>
__device__ __forceinline__ void to_member(ConvArgs& p) {
  const size_t m = blockIdx.z;
  const size_t pix = static_cast<size_t>(p.N) * p.H * p.W;
  const size_t out = m * pix * p.Cout;
  p.x = static_cast<const T*>(p.x) + m * pix * p.Cin;
  p.w = static_cast<const T*>(p.w) + m * 9 * static_cast<size_t>(p.Cin) *
                                         (p.ldw ? p.ldw : p.Cout);
  p.out = static_cast<T*>(p.out) + out;
  if (p.y != nullptr) p.y = static_cast<const T*>(p.y) + out;
  if (p.k1 != nullptr) p.k1 += out;
  if (p.aux != nullptr) p.aux = static_cast<T*>(p.aux) + out;
}

constexpr int kRowBytes = 128;  // one A row of one K step

template <typename T>
struct KStep {  // channels of one K step
  static constexpr int value = kRowBytes / sizeof(T);
};

// byte offset of 16-byte chunk `chunk` of row `row`, rows `row_bytes` long
__device__ __forceinline__ int swz(int row, int chunk, int row_bytes) {
  return row * row_bytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp_async_wait<n> for a depth n in 0..2 known only at run time
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Shared-memory loads at 32-bit shared addresses (the f32 kernels).
__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float lds32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// A 64-bit shared-memory matrix descriptor of wgmma for a 128-byte-swizzled
// tile whose swizzle atoms (8 rows x 128 B) start 1024-byte aligned:
// start address, leading and stride byte offsets (16-byte units), and the
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accesses to the accumulators across
// wgmma's asynchronous reads and writes of them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed shared-memory writes (cp.async included)
// visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A * B for one warpgroup: m64nNk16, bf16 in, f32 accumulate; A
// K-major, B MN-major (imm-trans-b 1), both from shared memory.  Thread t
// of the warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and, for each n8
// block j, columns 8j + 2*(t%4) (+1): d[4j], d[4j+1], then row + 8.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The same product with A from registers: a[0..3] hold this warp's 16 rows
// x 16 channels of A in the m16n8k16 fragment order, as ldmatrix.x4 loads
// them.  wgmma reads a[] asynchronously: keep it unchanged until a
// wgmma_wait shows the product done.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// The same register-A product with a narrow B (N = 8 or 16) read K-major
// (imm-trans-b 0): row n of B holds its 64 K values in one 128-byte
// swizzled row.  Thread t holds rows as in Wgmma, columns 2*(t%4) (+1) of
// each n8 block.
template <int N>
struct WgmmaRSNarrow;

template <>
struct WgmmaRSNarrow<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRSNarrow<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// N single-element copies of bf16 into shared memory: element j goes from
// src(j) (0 where src(j) is null) to dst(j); all N loads into registers
// first, then all N stores, so the loads are in flight together.
template <typename T, int N, typename Src, typename Dst>
__device__ __forceinline__ void copy_elems(const T* base, Src src, Dst dst) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 copies");
  T v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T* s = src(j);
    v[j] = s ? *s : from_f32<T>(0.0f);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) *reinterpret_cast<T*>(dst(j)) = v[j];
}

// T(gelu(T(v))) as f32: the Pallas kernels' _gelu of a rounded value
template <typename T>
__device__ __forceinline__ float gelu_rounded(float v) {
  return to_f32(from_f32<T>(gelu_exact(to_f32(from_f32<T>(v)))));
}

// V elements of T at p as f32; V is 1 or a multiple of 16 bytes' worth
// (p then 16-byte aligned)
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else {
    constexpr int E = 16 / sizeof(T);
    static_assert(V % E == 0, "whole 16-byte chunks");
#pragma unroll
    for (int c = 0; c < V / E; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) v[c * E + i] = to_f32(t[i]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    constexpr int E = 16 / sizeof(T);
    static_assert(V % E == 0, "whole 16-byte chunks");
#pragma unroll
    for (int c = 0; c < V / E; ++c) {
      uint4 raw;
      T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) t[i] = from_f32<T>(v[c * E + i]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  }
}

// The epilogue of V (1 or 8) neighbouring channels starting at element o.
template <typename T, int EPI, int V>
__device__ __forceinline__ void epilogue_v(const ConvArgs& p, size_t o,
                                           const float (&s)[V]) {
  T* out = static_cast<T*>(p.out) + o;
  float r[V];
  if constexpr (EPI == kStore) {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = s[i];
  } else if constexpr (EPI == kGelu) {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = gelu_rounded<T>(s[i]);
  } else if constexpr (EPI == kStage1) {
    float y[V];
    load_v<T, V>(static_cast<const T*>(p.y) + o, y);
    store_v<float, V>(p.k1 + o, s);
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = gelu_rounded<T>(y[i] + p.a * s[i]);
  } else {
    float y[V], k1[V];
    load_v<T, V>(static_cast<const T*>(p.y) + o, y);
    load_v<float, V>(p.k1 + o, k1);
#pragma unroll
    for (int i = 0; i < V; ++i)
      r[i] = to_f32(from_f32<T>(y[i] + p.a * (p.b1 * k1[i] + p.b2 * s[i])));
    if (p.aux != nullptr) {
      float g[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        g[i] = to_f32(from_f32<T>(gelu_exact(r[i])));
      store_v<T, V>(static_cast<T*>(p.aux) + o, g);
    }
  }
  store_v<T, V>(out, r);
}

// The epilogue of channels n .. n+7 of pixel m, sums s: 16-byte vector
// loads and stores where all eight are in range and Cout is a multiple of
// 8 (o then 16-byte aligned), else one element at a time.
template <typename T, int EPI>
__device__ __forceinline__ void epilogue_chunk(const ConvArgs& p, int m,
                                               int n, const float (&s)[8]) {
  const size_t o = static_cast<size_t>(m) * p.Cout + n;
  if (n + 8 <= p.Cout && (p.Cout & 7) == 0) {
    epilogue_v<T, EPI, 8>(p, o, s);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (n + i < p.Cout) {
      const float si[1] = {s[i]};
      epilogue_v<T, EPI, 1>(p, o + i, si);
    }
  }
}

// A warpgroup's m64 x BN wgmma sums (see Wgmma) into rows wg*64 .. +63 of
// the C tile in shared memory, rows kCRow floats long.
template <int BN, int kCRow>
__device__ __forceinline__ void wgmma_sums_to_smem(float* s_c,
                                                   const float (&acc)[BN / 2],
                                                   int warp, int lane) {
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(s_c + (r0 + 8 * h) * kCRow + 8 * j +
                                 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The epilogue of a BM x BN tile of f32 sums staged in shared memory, run
// in 8-channel chunks along each row, so every load and store of y, k1,
// out and aux is a coalesced 16-byte access.
template <typename T, int EPI, int BM, int BN, int kCRow, int kThreads>
__device__ __forceinline__ void epilogue_tile(const ConvArgs& p,
                                              const float* s_c, int m0,
                                              int n0, int M, int tid) {
  constexpr int kChunksRow = BN / 8;
  for (int i = tid; i < BM * kChunksRow; i += kThreads) {
    const int r = i / kChunksRow;
    const int c = (i % kChunksRow) * 8;
    const int m = m0 + r;
    if (m >= M || n0 + c >= p.Cout) continue;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(s_c + r * kCRow + c);
    const float4 hi =
        *reinterpret_cast<const float4*>(s_c + r * kCRow + c + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    epilogue_chunk<T, EPI>(p, m, n0 + c, v);
  }
}

// Tile shapes of the bf16 gather kernel: one warpgroup (4 warps) per 64
// rows of the tile, one m64nBNk16 wgmma each per 16 channels (WM = BM/16
// warps, WN = 1).  B lies in panels of 128-byte rows (64 columns), the
// layout wgmma reads as MN-major.
template <typename T, int BM, int BN, int WM, int WN, int STAGES>
struct Tile {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 tiles");
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BK = KStep<T>::value;
  static constexpr int kPanel = BK * kRowBytes;  // bytes of one B panel
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = BK * BN * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPixBytes = BM * 16;  // one int4 per tile row
  // 1 KB of slack aligns the ring to the 1024-byte swizzle atoms
  static constexpr size_t kSmemBytes =
      1024 + kPixBytes + static_cast<size_t>(STAGES) * kStageBytes;
  // the epilogue stages the f32 sums in the ring, rows padded by 4 floats
  static constexpr int kCRow = BN + 4;
  static_assert(BM * kCRow * 4 <= STAGES * kStageBytes, "C tile fits");
  static_assert((BN * sizeof(T)) % kRowBytes == 0, "whole B panels");
  static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0,
                "stages keep the 1024-byte alignment");
  static_assert(kThreads % BK == 0 && kThreads % BN == 0,
                "element copies give each thread one column");
};

// byte offset of 16-byte chunk `ch` of B row `k` (panels of 128-byte rows)
template <int BK>
__device__ __forceinline__ int b_off(int k, int ch) {
  return (ch >> 3) * (BK * kRowBytes) + swz(k, ch & 7, kRowBytes);
}

// The bf16 gather kernel: each K step copies its A tile (BM shifted pixel
// rows) and its B tile into the ring; ASYNC: by 16-byte cp.async (Cin a
// multiple of BK, Cout of 16 bytes), else element by element.
template <typename T, int BM, int BN, int WM, int WN, int STAGES, bool ASYNC,
          int EPI>
__global__ void __launch_bounds__(32 * WM * WN, 2)
conv3x3_igemm_kernel(ConvArgs p) {
  using Tl = Tile<T, BM, BN, WM, WN, STAGES>;
  constexpr int kThreads = Tl::kThreads;
  constexpr int BK = Tl::BK;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  // K steps loaded ahead: wgmma keeps one step's products in flight, so
  // the slot it reads is refilled one step later than a synchronous one
  constexpr int PD = STAGES - 2;
  static_assert(PD >= 1, "at least one step ahead");

  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* s_tiles = smem;
  int4* s_pix = reinterpret_cast<int4*>(
      smem + STAGES * Tl::kStageBytes);  // (m or -1, oh, ow, -)

  to_member<T>(p);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HW = p.H * p.W;
  const int M = p.N * HW;
  const int K = 9 * p.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  for (int r = tid; r < BM; r += kThreads) {
    const int m = m0 + r;
    int4 e = make_int4(-1, 0, 0, 0);
    if (m < M) {
      const int rem = m % HW;
      e = make_int4(m, rem / p.W, rem % p.W, 0);
    }
    s_pix[r] = e;
  }
  __syncthreads();

  const int ksteps = ASYNC ? K / BK : (K + BK - 1) / BK;
  const int steps_per_tap = p.Cin / BK;  // ASYNC only
  // element copies: this thread's column of A is k = step*BK + tid % BK,
  // tracked as (tap, channel) from step to step
  int e_tap = 0, e_c = 0;
  if (!ASYNC) {
    const int kk = tid % BK;
    e_tap = kk / p.Cin;
    e_c = kk - e_tap * p.Cin;
  }

  auto load_stage = [&](int s, int slot) {
    char* sA = s_tiles + slot * Tl::kStageBytes;
    char* sB = sA + Tl::kABytes;
    if constexpr (ASYNC) {
      const int tap = s / steps_per_tap;
      const int c0 = (s - tap * steps_per_tap) * BK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = tid; i < BM * 8; i += kThreads) {
        const int r = i >> 3, ch = i & 7;
        const int4 e = s_pix[r];
        const int ih = e.y + dy, iw = e.z + dx;
        const bool ok =
            e.x >= 0 && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
        const T* src =
            ok ? x + static_cast<size_t>(e.x + dy * p.W + dx) * p.Cin + c0 +
                     ch * E
               : x;
        cp_async16(smem_u32(sA + swz(r, ch, kRowBytes)), src, ok);
      }
    } else {
      const int kk = tid % BK;
      const bool kok = e_tap < 9;
      const int dy = e_tap / 3 - 1, dx = e_tap % 3 - 1;
      char* a_col = sA + (kk % E) * sizeof(T);
      copy_elems<T, BM * BK / kThreads>(
          x,
          [&](int j) -> const T* {
            const int4 e = s_pix[tid / BK + j * (kThreads / BK)];
            const int ih = e.y + dy, iw = e.z + dx;
            const bool ok = kok && e.x >= 0 && ih >= 0 && ih < p.H &&
                            iw >= 0 && iw < p.W;
            return ok ? x + static_cast<size_t>(e.x + dy * p.W + dx) * p.Cin +
                            e_c
                      : nullptr;
          },
          [&](int j) {
            return a_col +
                   swz(tid / BK + j * (kThreads / BK), kk / E, kRowBytes);
          });
      e_c += BK;
      while (e_c >= p.Cin) {
        e_c -= p.Cin;
        ++e_tap;
      }
    }
    // B rows s*BK .. s*BK + BK-1 of the (9*Cin, Cout) weights lie
    // contiguous whatever Cin is: 16-byte copies where Cout allows them
    if (ASYNC || p.Cout % E == 0) {
      constexpr int kChunks = BN / E;
#pragma unroll
      for (int i = tid; i < BK * kChunks; i += kThreads) {
        const int kr = i / kChunks, ch = i % kChunks;
        const int k = s * BK + kr;
        const int n = n0 + ch * E;
        const bool ok = n < p.Cout && k < K;
        const T* src = ok ? w + static_cast<size_t>(k) * p.Cout + n : w;
        cp_async16(smem_u32(sB + b_off<BK>(kr, ch)), src, ok);
      }
    } else {
      const int col = tid % BN;
      const bool nok = n0 + col < p.Cout;
      char* b_col = sB + (col % E) * sizeof(T);
      copy_elems<T, BK * BN / kThreads>(
          w,
          [&](int j) -> const T* {
            const int k = s * BK + tid / BN + j * (kThreads / BN);
            return nok && k < K ? w + static_cast<size_t>(k) * p.Cout + n0 + col
                                : nullptr;
          },
          [&](int j) {
            return b_col + b_off<BK>(tid / BN + j * (kThreads / BN), col / E);
          });
    }
  };

  // a warpgroup's m64 x BN accumulators, BN/2 per thread
  static_assert(WN == 1 && WM * 16 == BM && BM % 64 == 0,
                "one warpgroup per 64 rows");
  constexpr int kAcc = BN / 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int wg = warp >> 2;  // rows wg*64 .. wg*64 + 63

  auto compute_stage = [&](int slot) {
    const char* sA = s_tiles + slot * Tl::kStageBytes;
    const char* sB = sA + Tl::kABytes;
    // A: 128-byte rows, 8-row atoms 1024 B apart (SBO); a k16 slice starts
    // 32 B further.  B: MN-major panels Tl::kPanel apart (LBO), 8-row atoms
    // 1024 B apart (SBO); a k16 slice starts 2048 B further.
    const uint64_t da =
        sw128_desc(smem_u32(sA + wg * 64 * kRowBytes), 16, 1024);
    const uint64_t db = sw128_desc(smem_u32(sB), Tl::kPanel, 1024);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::run(acc, da + (kk * 32 >> 4), db + (kk * 2048 >> 4));
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
  };

#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<PD - 1>();
    fence_proxy_async();
    // step kt has landed for every thread; the slot refilled below was
    // last read by step kt + PD - STAGES, finished by every thread
    __syncthreads();
    const int next = kt + PD;
    if (next < ksteps) load_stage(next, next % STAGES);
    cp_async_commit();
    compute_stage(kt % STAGES);
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_operands(acc);

  __syncthreads();  // every warp is done with the ring
  float* s_c = reinterpret_cast<float*>(s_tiles);
  constexpr int kCRow = Tl::kCRow;
  wgmma_sums_to_smem<BN, kCRow>(s_c, acc, warp, lane);
  __syncthreads();
  epilogue_tile<T, EPI, BM, BN, kCRow, kThreads>(p, s_c, m0, n0, M, tid);
}

// The bf16 path where Cin is a multiple of 64 and Cout of 8: the input
// halo.  The source pixels of a block's BM output pixels m0 .. m0+BM-1
// under all nine taps are the contiguous pixels m0-W-1 .. m0+BM+W, so each
// 64-channel chunk of them (R = BM + 2W + 2 rows of 128 B) is copied once
// into shared memory, not once per tap.  A tap's A fragments are gathered
// from it by ldmatrix, whose lanes each address one row: row i of tap
// (dy, dx) is halo row i + dy*W + dx, or a zero row where that source
// pixel lies outside output pixel i's image (the SAME padding).  wgmma
// takes A from registers and the tap's weights B from the ring.  K runs
// chunk by chunk, the nine taps within a chunk; halos of successive chunks
// alternate between two buffers.
template <int BM, int BN, int STAGES, int EPI>
__global__ void __launch_bounds__(2 * BM, 256 / BM)
conv3x3_halo_kernel(ConvArgs p, int halo_rows) {
  using T = __nv_bfloat16;
  constexpr int kThreads = 2 * BM, BK = 64;  // one warpgroup per 64 rows
  constexpr int kPanel = BK * kRowBytes;
  constexpr int kBBytes = BK * BN * 2;
  constexpr int PD = STAGES - 1;  // steps loaded ahead
  constexpr int kCRow = BN + 4;

  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int R = halo_rows;
  const int nchunks = p.Cin / BK;
  const int nbuf = nchunks > 1 ? 2 : 1;
  char* s_ring = smem;                        // STAGES tiles of B
  char* s_halo = smem + STAGES * kBBytes;     // nbuf halos
  char* s_zero = s_halo + nbuf * R * kRowBytes;  // one row of zeros

  to_member<T>(p);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HW = p.H * p.W;
  const int M = p.N * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ksteps = 9 * nchunks;

  if (tid < kRowBytes / 16)
    reinterpret_cast<uint4*>(s_zero)[tid] = make_uint4(0, 0, 0, 0);

  // this lane's A row (ldmatrix lane l addresses row l & 15 of its warp's
  // 16, channel half l >> 4 of each 16-channel slice), and the taps whose
  // source pixel lies inside its image
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  const int ahalf = lane >> 4;
  unsigned valid = 0;
  if (m0 + arow < M) {
    const int rem = (m0 + arow) % HW;
    const int oh = rem / p.W, ow = rem % p.W;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ih = oh + t / 3 - 1, iw = ow + t % 3 - 1;
      if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) valid |= 1u << t;
    }
  }

  auto load_stage = [&](int s, int slot) {
    const int chunk = s / 9, tap = s - chunk * 9;
    if (tap == 0) {
      char* h = s_halo + (chunk % nbuf) * R * kRowBytes;
      const int q0 = m0 - p.W - 1;
      for (int i = tid; i < R * 8; i += kThreads) {
        const int q = i >> 3, ch = i & 7;
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < M;
        const T* src =
            ok ? x + static_cast<size_t>(pix) * p.Cin + chunk * BK + ch * 8
               : x;
        cp_async16(smem_u32(h + swz(q, ch, kRowBytes)), src, ok);
      }
    }
    char* sB = s_ring + slot * kBBytes;
    const T* wk = w + (static_cast<size_t>(tap) * p.Cin + chunk * BK) * p.Cout;
    constexpr int kChunks = BN / 8;
#pragma unroll
    for (int i = tid; i < BK * kChunks; i += kThreads) {
      const int kr = i / kChunks, ch = i % kChunks;
      const int n = n0 + ch * 8;
      const bool ok = n < p.Cout;
      const T* src = ok ? wk + static_cast<size_t>(kr) * p.Cout + n : w;
      cp_async16(smem_u32(sB + b_off<BK>(kr, ch)), src, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t af[BK / 16][4];  // this step's A fragments

  auto step = [&](int s) {
    cp_async_wait<PD - 1>();
    fence_proxy_async();
    // step s has landed for every thread; the ring slot refilled below was
    // last read by step s - 1, whose products every warpgroup waited for
    __syncthreads();
    if (s + PD < ksteps) load_stage(s + PD, (s + PD) % STAGES);
    cp_async_commit();
    const int chunk = s / 9, tap = s - chunk * 9;
    const char* h = s_halo + (chunk % nbuf) * R * kRowBytes;
    const int q = arow + (tap / 3) * p.W + tap % 3;
    const bool ok = (valid >> tap) & 1u;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int ch = kk * 2 + ahalf;
      ldmatrix_x4(af[kk], smem_u32(ok ? h + swz(q, ch, kRowBytes)
                                      : s_zero + ch * 16));
    }
    const uint64_t db =
        sw128_desc(smem_u32(s_ring + (s % STAGES) * kBBytes), kPanel, 1024);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<BN>::run(acc, af[kk], db + (kk * 2048 >> 4));
    wgmma_commit();
    // ptxas serializes wgmmas whose A registers are written while earlier
    // ones run, so each step waits for its own products: af is then free
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(af);
  };

#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < ksteps; ++s) step(s);
  cp_async_wait<0>();

  __syncthreads();  // every warp is done with the ring and the halos
  float* s_c = reinterpret_cast<float*>(smem);
  wgmma_sums_to_smem<BN, kCRow>(s_c, acc, warp, lane);
  __syncthreads();
  epilogue_tile<T, EPI, BM, BN, kCRow, kThreads>(p, s_c, m0, n0, M, tid);
}

// The halo kernel's A side with a narrow N tile, for Cout under 16 (the
// stem's 64 -> 3 dgrad): the same halo, ldmatrix gather and zero row, and
// wgmma m64nBNk16 (BN 8 or 16) with B read K-major, BN rows of 64 channels.
// Cout need not be a multiple of 8, so B is copied element by element
// (zero past Cout) and the epilogue writes only the columns that exist.
// kStore only: B2's convs are never this narrow.
template <int BN, int STAGES>
__global__ void __launch_bounds__(256, 4)
conv3x3_halo_narrow_kernel(ConvArgs p, int halo_rows) {
  using T = __nv_bfloat16;
  constexpr int BM = 128, kThreads = 256, BK = 64;
  constexpr int kBBytes = BN * kRowBytes;  // BN rows of BK channels
  constexpr int PD = STAGES - 1;
  constexpr int kCRow = BN + 4;
  static_assert(kBBytes % 1024 == 0, "ring slots keep the swizzle atoms");

  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int R = halo_rows;
  const int nchunks = p.Cin / BK;
  const int nbuf = nchunks > 1 ? 2 : 1;
  char* s_ring = smem;
  char* s_halo = smem + STAGES * kBBytes;
  char* s_zero = s_halo + nbuf * R * kRowBytes;

  to_member<T>(p);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int HW = p.H * p.W;
  const int M = p.N * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ksteps = 9 * nchunks;

  if (tid < kRowBytes / 16)
    reinterpret_cast<uint4*>(s_zero)[tid] = make_uint4(0, 0, 0, 0);

  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  const int ahalf = lane >> 4;
  unsigned valid = 0;
  if (m0 + arow < M) {
    const int rem = (m0 + arow) % HW;
    const int oh = rem / p.W, ow = rem % p.W;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int ih = oh + t / 3 - 1, iw = ow + t % 3 - 1;
      if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) valid |= 1u << t;
    }
  }

  // thread tid's elements of B: k = i / BN, n = i % BN for i = tid +
  // j*kThreads, so neighbouring threads read neighbouring weights
  auto load_stage = [&](int s, int slot) {
    const int chunk = s / 9, tap = s - chunk * 9;
    if (tap == 0) {
      char* h = s_halo + (chunk % nbuf) * R * kRowBytes;
      const int q0 = m0 - p.W - 1;
      for (int i = tid; i < R * 8; i += kThreads) {
        const int q = i >> 3, ch = i & 7;
        const int pix = q0 + q;
        const bool ok = pix >= 0 && pix < M;
        const T* src =
            ok ? x + static_cast<size_t>(pix) * p.Cin + chunk * BK + ch * 8
               : x;
        cp_async16(smem_u32(h + swz(q, ch, kRowBytes)), src, ok);
      }
    }
    char* sB = s_ring + slot * kBBytes;
    const T* wk = w + (static_cast<size_t>(tap) * p.Cin + chunk * BK) * p.Cout;
    copy_elems<T, BN * BK / kThreads>(
        w,
        [&](int j) -> const T* {
          const int i = tid + j * kThreads;
          const int n = n0 + i % BN;
          return n < p.Cout ? wk + static_cast<size_t>(i / BN) * p.Cout + n
                            : nullptr;
        },
        [&](int j) {
          const int i = tid + j * kThreads;
          const int k = i / BN, n = i % BN;
          return sB + swz(n, k >> 3, kRowBytes) + (k & 7) * 2;
        });
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t af[BK / 16][4];

  auto step = [&](int s) {
    cp_async_wait<PD - 1>();
    // this thread's element stores of B and its landed copies, then every
    // thread's, reach the async proxy that wgmma reads through
    fence_proxy_async();
    __syncthreads();
    if (s + PD < ksteps) load_stage(s + PD, (s + PD) % STAGES);
    cp_async_commit();
    const int chunk = s / 9, tap = s - chunk * 9;
    const char* h = s_halo + (chunk % nbuf) * R * kRowBytes;
    const int q = arow + (tap / 3) * p.W + tap % 3;
    const bool ok = (valid >> tap) & 1u;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int ch = kk * 2 + ahalf;
      ldmatrix_x4(af[kk], smem_u32(ok ? h + swz(q, ch, kRowBytes)
                                      : s_zero + ch * 16));
    }
    // K-major B: 8-row atoms 1024 B apart (SBO); a k16 slice starts 32 B in
    const uint64_t db =
        sw128_desc(smem_u32(s_ring + (s % STAGES) * kBBytes), 16, 1024);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRSNarrow<BN>::run(acc, af[kk], db + (kk * 32 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(af);
  };

#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < ksteps; ++s) step(s);
  cp_async_wait<0>();

  __syncthreads();
  float* s_c = reinterpret_cast<float*>(smem);
  wgmma_sums_to_smem<BN, kCRow>(s_c, acc, warp, lane);
  __syncthreads();
  epilogue_tile<T, kStore, BM, BN, kCRow, kThreads>(p, s_c, m0, n0, M, tid);
}

// The device's opt-in shared memory per block, read once per device.
inline cudaError_t smem_optin(int device, int* bytes) {
  static std::atomic<int> limit[kMaxDevices];  // 0: not read yet
  int v = limit[device].load(std::memory_order_relaxed);
  if (v == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    limit[device].store(v, std::memory_order_relaxed);
  }
  *bytes = v;
  return cudaSuccess;
}

// Dynamic shared memory of a halo kernel (either width): 1 KB of alignment
// slack, a ring of STAGES B tiles of 64 channels x BN, one or two halos of
// BM + 2W + 2 rows and the zero row, or the staged C tile where larger.
inline long long halo_smem_bytes(const ConvArgs& p, int BM, int BN,
                                 int STAGES) {
  const long long rows = BM + 2LL * p.W + 2;
  const long long nbuf = p.Cin > 64 ? 2 : 1;
  const long long bytes = 1024 + STAGES * (64LL * BN * 2) +
                          nbuf * rows * kRowBytes + kRowBytes;
  const long long c_bytes = 1024 + static_cast<long long>(BM) * (BN + 4) * 4;
  return bytes > c_bytes ? bytes : c_bytes;
}

// Launch a halo kernel (wide or narrow) whose shared memory the caller has
// checked fits.  The kernel instance is allowed the whole opt-in size once
// per device, on its first launch (which callers make outside any
// CUDA-graph capture), since the halo's size depends on W.
template <int BM, int BN, int STAGES, typename Kernel>
cudaError_t launch_halo(Kernel kernel, const ConvArgs& p, int device,
                        int optin, std::atomic<bool>* opted,
                        cudaStream_t stream) {
  if (!opted[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const long long M = static_cast<long long>(p.N) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((p.Cout + BN - 1) / BN),
                  static_cast<unsigned>(p.S));
  kernel<<<grid, 2 * BM,
           static_cast<size_t>(halo_smem_bytes(p, BM, BN, STAGES)), stream>>>(
      p, static_cast<int>(BM + 2 * p.W + 2));
  return cudaGetLastError();
}

template <int BM, int BN, int STAGES, int EPI>
cudaError_t launch_halo_wide(const ConvArgs& p, int device, int optin,
                             cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  return launch_halo<BM, BN, STAGES>(conv3x3_halo_kernel<BM, BN, STAGES, EPI>,
                                     p, device, optin, opted, stream);
}

template <int BN, int STAGES>
cudaError_t launch_halo_narrow(const ConvArgs& p, int device, int optin,
                               cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  return launch_halo<128, BN, STAGES>(conv3x3_halo_narrow_kernel<BN, STAGES>,
                                      p, device, optin, opted, stream);
}

// Launch one tile configuration.  Dynamic shared memory above 48 KB is
// allowed once per device and kernel instance, on its first launch (which
// callers make outside any CUDA-graph capture).
template <typename T, int BM, int BN, int WM, int WN, int STAGES, bool ASYNC,
          int EPI>
cudaError_t launch_tile(const ConvArgs& p, int device, cudaStream_t stream) {
  using Tl = Tile<T, BM, BN, WM, WN, STAGES>;
  auto kernel = conv3x3_igemm_kernel<T, BM, BN, WM, WN, STAGES, ASYNC, EPI>;
  static std::atomic<bool> opted[kMaxDevices];
  if (Tl::kSmemBytes > 48 * 1024 &&
      !opted[device].load(std::memory_order_relaxed)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tl::kSmemBytes));
    if (err != cudaSuccess) return err;
    opted[device].store(true, std::memory_order_relaxed);
  }
  const long long M = static_cast<long long>(p.N) * p.H * p.W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((p.Cout + BN - 1) / BN),
                  static_cast<unsigned>(p.S));
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool ASYNC, int EPI>
cudaError_t launch_shape(const ConvArgs& p, int device, cudaStream_t stream) {
  // 128 x 64 tiles for Cout <= 64, else 128 x 128; two warpgroups, two
  // blocks per SM either way
  if (p.Cout <= 64)
    return launch_tile<T, 128, 64, 8, 1, 3, ASYNC, EPI>(p, device, stream);
  return launch_tile<T, 128, 128, 8, 1, 3, ASYNC, EPI>(p, device, stream);
}

// The kernel a conv runs on (ops/conv3x3.py::CONV_PATHS names them).
enum ConvPath {
  kPathGather = 0,        // bf16 igemm kernel, 16-byte cp.async of A and B
  kPathGatherElems = 1,   // bf16 igemm kernel, element copies
  kPathHalo = 2,          // bf16, Cin a multiple of 64, Cout of 8 (>= 16)
  kPathHaloNarrow = 3,    // bf16, Cin a multiple of 64, Cout under 16
  kPathF32Halo = 4,       // f32 core, the contiguous halo (conv3x3_f32.cuh)
  kPathF32Bands = 5,      // f32 core, three bands (W > BM + 2)
};

// Picks the bf16 path from the shapes and the device's opt-in shared
// memory: a halo path where its shared memory fits, else a gather path.
template <int EPI>
ConvPath conv_path(const ConvArgs& p, int optin) {
  using T = __nv_bfloat16;
  constexpr int BK = KStep<T>::value;
  constexpr int E = 16 / sizeof(T);
  const bool aligned = p.Cin % BK == 0 && p.Cout % E == 0;
  if (EPI == kStore && p.Cin % BK == 0 && p.Cout < 16 &&
      halo_smem_bytes(p, 128, p.Cout <= 8 ? 8 : 16, 4) <= optin)
    return kPathHaloNarrow;
  if (aligned && halo_smem_bytes(p, 128, p.Cout <= 64 ? 64 : 128, 4) <= optin)
    return kPathHalo;
  return aligned ? kPathGather : kPathGatherElems;
}

// Checks the arguments and reads the device's shared-memory limit.
inline cudaError_t conv3x3_prepare(const ConvArgs& p, int device,
                                   int* optin) {
  // members run on grid dimension z, which holds at most 65,535
  if (p.N < 1 || p.H < 1 || p.W < 1 || p.Cin < 1 || p.Cout < 1 ||
      p.S < 1 || p.S > 65535 ||
      static_cast<long long>(p.N) * p.H * p.W >= (1LL << 31) ||
      9LL * p.Cin >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return smem_optin(device, optin);
}

// The bf16 conv on the path conv_path picks.
template <int EPI>
cudaError_t launch_conv3x3_bf16(const ConvArgs& p, int device, void* stream) {
  using T = __nv_bfloat16;
  int optin = 0;
  cudaError_t err = conv3x3_prepare(p, device, &optin);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (conv_path<EPI>(p, optin)) {
    case kPathHaloNarrow:
      if constexpr (EPI == kStore)
        return p.Cout <= 8 ? launch_halo_narrow<8, 4>(p, device, optin, st)
                           : launch_halo_narrow<16, 4>(p, device, optin, st);
      return cudaErrorInvalidValue;
    case kPathHalo:
      return p.Cout <= 64
                 ? launch_halo_wide<128, 64, 4, EPI>(p, device, optin, st)
                 : launch_halo_wide<128, 128, 4, EPI>(p, device, optin, st);
    case kPathGather:
      return launch_shape<T, true, EPI>(p, device, st);
    default:
      return launch_shape<T, false, EPI>(p, device, st);
  }
}

}  // namespace nodems
