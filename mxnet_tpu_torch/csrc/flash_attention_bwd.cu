// FlashAttention-2 backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, each with a plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_attention.py::_dq_kernel (:190-238) and
// ::_dkv_kernel (:241-294), the two pl.pallas_call launches of
// _flash_bwd_call (:297-357).
//
// What they compute, per (b*h), query row i and key row j (Tq == Tk;
// causal keeps j <= i, the top-left square mask of the TPU kernels), from
// q, k, v, O, dO and the forward's L = LSE, read as given (ring attention
// hands in a global L):
//   s_ij = (q_i . k_j) * scale in f32 (inputs upcast), -1e30 where masked;
//   p_ij = exp(s_ij - L_i), zeroed where s_ij <= -5e29, so a fully masked
//   row (L = -1e30) gives zero gradients;
//   D_i = rowsum(dO_i * O_i) in f32;  dp_ij = dO_i . v_j in f32;
//   ds_ij = p_ij * (dp_ij - D_i) * scale;
//   dQ_i = sum_j round_k(ds_ij) k_j, dV_j = sum_i round_dO(p_ij) dO_i,
//   dK_j = sum_i round_q(ds_ij) q_i, all summed in f32, where round_x
//   rounds to x's dtype (a no-op in f32; the TPU kernels' astype before
//   each product) and the sums are stored in the inputs' dtype.
//
// Layout: q, k, v, O, dO, dQ, dK, dV are contiguous (B*H, T, D), D in
// {16, 32, 64, 128}, f32 or bf16; L and D are (B*H, T) f32.  The Python
// wrapper makes every input contiguous (the trunk's head split hands in
// transposed views and autograd may hand in a strided dO) and allocates
// the outputs; this file allocates nothing and never synchronises.
//
// Design, simple and right first.  Two kernels on two grids, each output
// tile with exactly one writer block and no atomics:
// - dQ: one block per (b*h, 64-row q tile), kv streamed through shared
//   memory in 32-row tiles up to the diagonal's tile when causal; the q
//   tiles with the most causal work are scheduled first.  It computes D
//   for its rows from dO and O and also writes D as a (B*H, T) f32 side
//   output: 4 bytes a row, where the TPU's dK/dV kernel recomputes D for
//   every (kv tile, q tile) pair (:271).  The wrapper launches it first,
//   on the same stream as the dK/dV kernel that reads D.
// - dK/dV: one block per (b*h, kv tile of 64 rows, 32 at D = 128), q, dO,
//   L and D streamed through shared memory in 32-row tiles, starting at
//   the tile's first row k0 when causal (no row above k0 sees these keys;
//   tiles need not be aligned) and running to T; early kv tiles carry the
//   most causal work and run first.
// Each row of a block is split over neighbouring threads of one warp, 32
// head dims a thread (one thread at D <= 32, two at D = 64, four at
// D = 128), each holding its slice of the row and of the f32 accumulators
// in registers (q, dO, dQ in the dQ kernel; k, v, dK, dV in the dK/dV
// kernel) and summing dot products with shuffles.  Blocks stay at 256
// threads or fewer.  With L given, no tile-wide maximum is needed: each
// (row, streamed row) pair is finished on its own, two streamed rows at a
// time.  All threads holding the same slice read the same streamed element
// at once, so shared-memory reads are broadcasts, and the slices of a row
// are padded apart to fall in different banks.  A ragged tail (T not a
// multiple of the tiles) is masked here: rows >= T are loaded as zeros,
// masked as keys, and never stored.  FMA loops only: mma.sync, wgmma, TMA
// and a fused single-pass backward with dQ by atomics are later work.
// The split and the group size come from tools/sweep_flash_bwd.py at the
// slice's shape: of 18 variants (16 or 32 dims a thread in the dQ kernel,
// 8, 16 or 32 in the dK/dV kernel, groups of 2, 4 or 8 rows) this one is
// the fastest in f32 and bf16; with groups of 8 the dK/dV kernel spills
// registers and runs 12x slower.
//
// Bound at the slice's shape (B=8, H=12, T=1024, D=64, causal), reckoned
// from shapes: 50.4 M visible (query, key) pairs.  The function needs
// 10*D flops a pair (S, dP, dV, dK, dQ): 32.2 GFLOP.  f32 (TF32 off, so
// no tensor cores): 0.481 ms at the 67 TFLOP/s FMA peak against 0.060 ms
// for 201 MB of q, k, v, O, dO, dQ, dK, dV: operation-bound.  bf16:
// 0.033 ms of tensor-core time at 989 TFLOP/s against 0.030 ms for
// 101 MB: operation-bound by a hair.  This split design does 14*D a pair
// (S and dP in both kernels): 45.1 GFLOP, 0.674 ms at the f32 FMA peak,
// of which dQ 6*D (0.289 ms) and dK/dV 8*D (0.385 ms).  Both kernels run
// on the FMA units in both types, so their own ceiling is the f32 FMA
// peak; closing the bf16 gap needs tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTile = 32;   // streamed rows per shared-memory tile
constexpr int kGroup = 2;   // streamed rows whose dot products run together
// head dims a thread holds in each kernel (mxnet_tpu_torch/tools/
// sweep_flash_bwd.py varies these three constants)
constexpr int kDqDims = 32;
constexpr int kDkvDims = 32;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
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
};

template <int D, int kMaxDims>
struct Cfg {
  static constexpr int kDimsPerThread = D < kMaxDims ? D : kMaxDims;
  static constexpr int kThreadsPerRow = D / kDimsPerThread;
  // rows (q rows for dQ, kv rows for dK/dV) per block: 64, fewer where
  // that would take more than 256 threads
  static constexpr int kRows = 256 / kThreadsPerRow < 64
                                   ? 256 / kThreadsPerRow : 64;
  static constexpr int kThreads = kRows * kThreadsPerRow;
  // A thread's slice of a streamed row starts kPad floats after the
  // previous slice, so the slices of one row fall in different banks.
  static constexpr int kPad = kThreadsPerRow > 1 ? 4 : 0;
  static constexpr int kRow = D + kPad * (kThreadsPerRow - 1);
  static_assert(kDimsPerThread % 4 == 0, "float4 reads of a row slice");
  static_assert(32 % kThreadsPerRow == 0, "a row's threads share a warp");
};

// Rows [r0, r0 + kTile) of a (T, D) slab into shared memory as f32, in the
// padded layout; rows >= seq are zeros.
template <typename T, int D, typename C>
__device__ __forceinline__ void stage(float (*dst)[C::kRow],
                                      const T* __restrict__ src, size_t base,
                                      int r0, int seq) {
  constexpr int DPT = C::kDimsPerThread;
  for (int idx = threadIdx.x; idx < kTile * D; idx += C::kThreads) {
    const int j = idx / D, d = idx % D;
    const int r = r0 + j;
    dst[j][d + (d / DPT) * C::kPad] =
        r < seq ? Elem<T>::load(src[base + static_cast<size_t>(r) * D + d])
                : 0.f;
  }
}

// Sums x over the kThreadsPerRow neighbouring lanes that share a row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// For each of kGroup streamed rows: s[j] = a . A[j], t[j] = b . B[j] over
// this thread's slice, then summed over the row's threads.
template <typename C>
__device__ __forceinline__ void dots(const float* a, const float* b,
                                     float (*A)[C::kRow], float (*B)[C::kRow],
                                     int dsh, float* s, float* t) {
  constexpr int DPT = C::kDimsPerThread;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) s[j] = t[j] = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; i += 4) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(&A[j][dsh + i]);
      const float4 y = *reinterpret_cast<const float4*>(&B[j][dsh + i]);
      s[j] = fmaf(a[i], x.x, s[j]);
      s[j] = fmaf(a[i + 1], x.y, s[j]);
      s[j] = fmaf(a[i + 2], x.z, s[j]);
      s[j] = fmaf(a[i + 3], x.w, s[j]);
      t[j] = fmaf(b[i], y.x, t[j]);
      t[j] = fmaf(b[i + 1], y.y, t[j]);
      t[j] = fmaf(b[i + 2], y.z, t[j]);
      t[j] = fmaf(b[i + 3], y.w, t[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    s[j] = row_sum<C::kThreadsPerRow>(s[j]);
    t[j] = row_sum<C::kThreadsPerRow>(t[j]);
  }
}

// acc += w * x over this thread's slice.
template <int DPT>
__device__ __forceinline__ void axpy(float* acc, float w, const float* x) {
#pragma unroll
  for (int i = 0; i < DPT; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    acc[i] = fmaf(w, v.x, acc[i]);
    acc[i + 1] = fmaf(w, v.y, acc[i + 1]);
    acc[i + 2] = fmaf(w, v.z, acc[i + 2]);
    acc[i + 3] = fmaf(w, v.w, acc[i + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D, kDqDims>::kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dq, float* __restrict__ delta, int seq,
                float scale, int causal) {
  using E = Elem<T>;
  using C = Cfg<D, kDqDims>;
  constexpr int DPT = C::kDimsPerThread;
  __shared__ __align__(16) float ks[kTile][C::kRow];
  __shared__ __align__(16) float vs[kTile][C::kRow];

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  const int tid = threadIdx.x;
  const int part = tid % C::kThreadsPerRow;
  const int qpos = q0 + tid / C::kThreadsPerRow;
  const bool live = qpos < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const int dsh = part * (DPT + C::kPad);
  const size_t row = base + static_cast<size_t>(live ? qpos : 0) * D +
                     part * DPT;

  float qr[DPT], gr[DPT], acc[DPT];
  float di = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? E::load(q[row + i]) : 0.f;
    gr[i] = live ? E::load(dout[row + i]) : 0.f;
    di = fmaf(gr[i], live ? E::load(o[row + i]) : 0.f, di);
    acc[i] = 0.f;
  }
  di = row_sum<C::kThreadsPerRow>(di);
  const size_t lrow_at = static_cast<size_t>(bh) * seq + qpos;
  const float lrow = live ? lse[lrow_at] : 0.f;
  if (live && part == 0) delta[lrow_at] = di;

  const int kv_end = causal ? min(seq, q0 + C::kRows) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D, C>(ks, k, base, k0, seq);
    stage<T, D, C>(vs, v, base, k0, seq);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kGroup) {
      float s[kGroup], dp[kGroup];
      dots<C>(qr, gr, ks + j0, vs + j0, dsh, s, dp);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int kp = k0 + j0 + j;
        const bool masked = !live || kp >= seq || (causal && kp > qpos);
        const float sv = masked ? kNeg : s[j] * scale;
        const float p = sv <= 0.5f * kNeg ? 0.f : expf(sv - lrow);
        const float ds = E::round(p * (dp[j] - di) * scale);
        axpy<DPT>(acc, ds, &ks[j0 + j][dsh]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[row + i] = E::store(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D, kDkvDims>::kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lse,
                 const T* __restrict__ dout, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int seq, float scale,
                 int causal) {
  using E = Elem<T>;
  using C = Cfg<D, kDkvDims>;
  constexpr int DPT = C::kDimsPerThread;
  __shared__ __align__(16) float qs[kTile][C::kRow];
  __shared__ __align__(16) float gs[kTile][C::kRow];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * C::kRows;
  const int tid = threadIdx.x;
  const int part = tid % C::kThreadsPerRow;
  const int kpos = k0 + tid / C::kThreadsPerRow;
  const bool live = kpos < seq;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t lbase = static_cast<size_t>(bh) * seq;
  const int dsh = part * (DPT + C::kPad);
  const size_t row = base + static_cast<size_t>(live ? kpos : 0) * D +
                     part * DPT;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = live ? E::load(k[row + i]) : 0.f;
    vr[i] = live ? E::load(v[row + i]) : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int r0 = causal ? k0 : 0; r0 < seq; r0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D, C>(qs, q, base, r0, seq);
    stage<T, D, C>(gs, dout, base, r0, seq);
    for (int j = tid; j < kTile; j += C::kThreads) {
      const int r = r0 + j;
      ls[j] = r < seq ? lse[lbase + r] : 0.f;
      dls[j] = r < seq ? delta[lbase + r] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kGroup) {
      float s[kGroup], dp[kGroup];
      dots<C>(kr, vr, qs + j0, gs + j0, dsh, s, dp);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int qp = r0 + j0 + j;
        const bool masked = !live || qp >= seq || (causal && qp < kpos);
        const float sv = masked ? kNeg : s[j] * scale;
        const float p = sv <= 0.5f * kNeg ? 0.f : expf(sv - ls[j0 + j]);
        const float ds = p * (dp[j] - dls[j0 + j]) * scale;
        axpy<DPT>(dva, E::round(p), &gs[j0 + j][dsh]);
        axpy<DPT>(dka, E::round(ds), &qs[j0 + j][dsh]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[row + i] = E::store(dka[i]);
      dv[row + i] = E::store(dva[i]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // dQ only
  const void* lse;
  const void* dout;
  const void* delta;  // dK/dV only (input)
  void* out0;         // dQ, or dK
  void* out1;         // D (side output), or dV
  int bh, seq, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  using C = Cfg<D, kDqDims>;
  const int tiles = (a.seq + C::kRows - 1) / C::kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_dq_kernel<T, D><<<dim3(a.bh, tiles), C::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const float*>(a.lse), static_cast<const T*>(a.dout),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.seq, a.scale,
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  using C = Cfg<D, kDkvDims>;
  const int tiles = (a.seq + C::kRows - 1) / C::kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_dkv_kernel<T, D><<<dim3(a.bh, tiles), C::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.seq, a.scale,
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq, typename T>
int by_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int dispatch(int head_dim, int dtype, const Args& a) {
  if (a.bh < 1 || a.seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return by_dim<kDq, float>(head_dim, a);
    case 1: return by_dim<kDq, __nv_bfloat16>(head_dim, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t: 0 on a
// successful launch, cudaErrorInvalidValue for a shape or type it does
// not take.

// dQ (like q) and D = rowsum(dO * O) ((B*H, T) f32) from q, k, v, O, L, dO.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, void* dq, void* delta,
                                  int bh, int seq, int head_dim, int dtype,
                                  int causal, float scale, void* stream) {
  const Args a{q, k, v, o, lse, dout, nullptr, dq, delta, bh, seq, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(head_dim, dtype, a);
}

// dK and dV (like k and v) from q, k, v, L, dO and the dQ kernel's D.
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* lse,
                                   const void* dout, const void* delta,
                                   void* dk, void* dv, int bh, int seq,
                                   int head_dim, int dtype, int causal,
                                   float scale, void* stream) {
  const Args a{q, k, v, nullptr, lse, dout, delta, dk, dv, bh, seq, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(head_dim, dtype, a);
}
