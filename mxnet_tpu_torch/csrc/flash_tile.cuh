// Shared tile layer of the flash-attention kernels for Hopper (sm_90a):
// tensor-core atoms, fragment loads, the swizzled shared-memory layout and
// the asynchronous copies.  Its users: the forward kernel
// (flash_attention_fwd.cu) and the dQ and dK/dV kernels
// (flash_attention_bwd.cu).
//
// Atoms (one warp, a 16 x 8 f32 accumulator tile per product):
// - bf16: mma.sync m16n8k16 bf16 x bf16 -> f32.
// - f32: 3xTF32 on mma.sync m16n8k8 tf32 x tf32 -> f32.  Each operand x is
//   split into big = rna_tf32(x) and small = rna_tf32(x - big); the atom
//   accumulates small*big + big*small + big*big in f32 and drops
//   small*small, so a product keeps ~22 bits of each operand, f32 accuracy
//   on tensor cores (495 TFLOP/s TF32 / 3 = ~165 TFLOP/s of f32 work,
//   against 67 TFLOP/s on the FMA units).  No product is taken at TF32
//   precision, so the port's "TF32 off" rule stands.
// The m16n8 accumulator layout (lane = 4 * g + t holds rows g and g + 8,
// columns 2t and 2t + 1 of each 8-column block) is also the per-warp
// layout of wgmma's accumulator, so moving the bf16 products to wgmma
// later touches only the atom.
//
// Operands come from shared memory by fragment loads:
// - load_a:    A[m][k] = tile[r0 + m][k0 + k]   (contraction along a row)
// - load_b_nk: B[k][n] = tile[n0 + n][k0 + k]   (contraction along a row)
// - load_b_kn: B[k][n] = tile[k0 + k][n0 + n]   (contraction down the rows)
// and a_from_c turns accumulator tiles into the A operand of the next
// product in registers (FlashAttention-2's reuse of P).  bf16 uses
// ldmatrix (.trans for load_b_kn); f32 uses 32-bit shared loads and splits
// on load.  For the tf32 k8 atom, the accumulator's columns 2t and 2t + 1
// become k slots t and t + 4, so a_from_c and load_b_kn use that same
// permutation of k (any permutation of a contraction index, applied to
// both operands, leaves the product unchanged); load_a and load_b_nk keep
// the natural order and are only ever paired with each other.
//
// Shared memory holds a tile of R rows x D elements as 16-byte chunks, row
// after row, with chunk c of row r stored at c ^ ((r >> kShift) & (kS - 1)):
// an XOR swizzle under which the eight rows read by one ldmatrix phase, or
// the 8 x 4 words read by a 32-bit fragment load, fall in distinct banks.
// Tiles arrive by cp.async.cg 16-byte copies (rows >= T zero-filled by the
// copy's src-size operand) into a ring of stages, commit_group/wait_group.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace flash {

constexpr float kNeg = -1e30f;   // masked score
constexpr float kZeroBelow = 0.5f * kNeg;   // p = 0 where s <= this
constexpr float kLog2e = 1.4426950408889634f;

// 2^y by one MUFU.EX2 (relative error ~2^-22; results below 2^-126 flush
// to zero).
__device__ __forceinline__ float exp2_of(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return r;
}

// exp(x - m) as 2^(x log2 e - m log2 e): one FMA and one EX2, with
// mb = m * kLog2e.
__device__ __forceinline__ float exp_from(float x, float mb) {
  return exp2_of(fmaf(x, kLog2e, -mb));
}

// -- element types ---------------------------------------------------------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  // two neighbouring outputs (even offset) in one store
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// -- shared-memory layout --------------------------------------------------

template <typename T, int D>
struct Layout {
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int kChunks = D / kEpc;                         // per row
  static constexpr int kS = kChunks < 8 ? kChunks : 8;
  static constexpr int kShift = kS == 2 ? 2 : (kS == 4 ? 1 : 0);
  static_assert(kChunks >= 2 && (kChunks & (kChunks - 1)) == 0,
                "rows of a power-of-two number of 16-byte chunks");
  static __device__ __forceinline__ int chunk(int r, int c) {
    return r * kChunks + (c ^ ((r >> kShift) & (kS - 1)));
  }
  // element offset of (row r, column e)
  static __device__ __forceinline__ int at(int r, int e) {
    return chunk(r, e / kEpc) * kEpc + e % kEpc;
  }
};

// -- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of a (seq, D) slab into a swizzled tile, by all
// kThreads threads of the block; rows >= seq are zeros.
template <typename T, int R, int D, int kThreads>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ src,
                                          int row0, int seq) {
  using L = Layout<T, D>;
#pragma unroll
  for (int idx = threadIdx.x; idx < R * L::kChunks; idx += kThreads) {
    const int r = idx / L::kChunks, c = idx % L::kChunks;
    const bool ok = row0 + r < seq;
    const T* g = src + static_cast<size_t>(ok ? row0 + r : 0) * D + c * L::kEpc;
    cp_async16(tile + L::chunk(r, c) * L::kEpc, g, ok);
  }
}

// R f32 values [row0, row0 + R) of a length-seq row into shared memory;
// entries >= seq are zeros.  4-byte copies: a row of L or D is not 16-byte
// aligned when seq is not a multiple of 4.
template <int R, int kThreads>
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int seq) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool ok = row0 + i < seq;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// -- tensor-core atoms -----------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Atom;

// bf16 x bf16 -> f32, k = 16.
template <>
struct Atom<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  template <int D>
  static __device__ __forceinline__ void load_a(const T* tile, int r0, int k0,
                                                A& a) {
    const int l = threadIdx.x & 31;
    const int r = r0 + (l & 7) + ((l >> 3) & 1) * 8;
    ldsm_x4(a.x, tile + Layout<T, D>::at(r, k0 + (l >> 4) * 8));
  }
  template <int D>
  static __device__ __forceinline__ void load_b_nk(const T* tile, int n0,
                                                   int k0, B& b) {
    const int l = threadIdx.x & 15;   // lanes 16-31: ignored, kept valid
    ldsm_x2(b.x, tile + Layout<T, D>::at(n0 + (l & 7), k0 + (l >> 3) * 8));
  }
  template <int D>
  static __device__ __forceinline__ void load_b_kn(const T* tile, int k0,
                                                   int n0, B& b) {
    const int l = threadIdx.x & 15;
    ldsm_x2_trans(b.x, tile + Layout<T, D>::at(k0 + (l & 7) + (l >> 3) * 8,
                                               n0));
  }
  // A of the next product from accumulator blocks 2kk and 2kk + 1 (k =
  // their 16 columns), rounded to bf16.
  static __device__ __forceinline__ void a_from_c(const float (*c)[4], int kk,
                                                  A& a) {
    a.x[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a.x[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a.x[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.x[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x);
  }
};

// f32 by 3xTF32, k = 8.
template <>
struct Atom<float> {
  using T = float;
  static constexpr int kK = 8;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };

  static __device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
  static __device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

  template <int D>
  static __device__ __forceinline__ void load_a(const T* tile, int r0, int k0,
                                                A& a) {
    using L = Layout<T, D>;
    const int g = lane_g(), t = lane_t();
    split_tf32(tile[L::at(r0 + g, k0 + t)], a.big[0], a.small[0]);
    split_tf32(tile[L::at(r0 + g + 8, k0 + t)], a.big[1], a.small[1]);
    split_tf32(tile[L::at(r0 + g, k0 + t + 4)], a.big[2], a.small[2]);
    split_tf32(tile[L::at(r0 + g + 8, k0 + t + 4)], a.big[3], a.small[3]);
  }
  template <int D>
  static __device__ __forceinline__ void load_b_nk(const T* tile, int n0,
                                                   int k0, B& b) {
    using L = Layout<T, D>;
    const int g = lane_g(), t = lane_t();
    split_tf32(tile[L::at(n0 + g, k0 + t)], b.big[0], b.small[0]);
    split_tf32(tile[L::at(n0 + g, k0 + t + 4)], b.big[1], b.small[1]);
  }
  // k slots t and t + 4 are rows k0 + 2t and k0 + 2t + 1 (see a_from_c)
  template <int D>
  static __device__ __forceinline__ void load_b_kn(const T* tile, int k0,
                                                   int n0, B& b) {
    using L = Layout<T, D>;
    const int g = lane_g(), t = lane_t();
    split_tf32(tile[L::at(k0 + 2 * t, n0 + g)], b.big[0], b.small[0]);
    split_tf32(tile[L::at(k0 + 2 * t + 1, n0 + g)], b.big[1], b.small[1]);
  }
  // A of the next product from accumulator block kk: its columns 2t and
  // 2t + 1 become k slots t and t + 4.
  static __device__ __forceinline__ void a_from_c(const float (*c)[4], int kk,
                                                  A& a) {
    split_tf32(c[kk][0], a.big[0], a.small[0]);
    split_tf32(c[kk][2], a.big[1], a.small[1]);
    split_tf32(c[kk][1], a.big[2], a.small[2]);
    split_tf32(c[kk][3], a.big[3], a.small[3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.big, b.big);
  }
};

// Sum of x over the four lanes of a quad (the lanes that share a row of an
// accumulator tile).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Opts a kernel into more than 48 KB of dynamic shared memory (once per
// kernel); returns a cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace flash
