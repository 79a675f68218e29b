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
//   s_ij = (q_i . k_j) * scale with f32 accumulation, -1e30 where masked;
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
// {16, 32, 64, 128}, f32 or bf16, 16-byte aligned; L and D are (B*H, T)
// f32.  The Python wrapper makes every input contiguous and aligned (the
// trunk's head split hands in transposed views and autograd may hand in a
// strided dO) and allocates the outputs; this file allocates nothing and
// never synchronises.
//
// Two kernels on two grids, each output tile with exactly one writer block
// and no atomics.  The wrapper launches the dQ kernel first, on the same
// stream as the dK/dV kernel that reads its D.
//
// Bound at the training shape (B=8, H=12, T=1024, D=64, causal), reckoned
// from shapes: 50.4 M visible (query, key) pairs.  The function needs
// 10*D flops a pair (S, dP, dV, dK, dQ): 32.2 GFLOP; this split design
// does 14*D (S and dP in both kernels), of which dQ 6*D and dK/dV 8*D
// (25.8 GFLOP).  dK/dV alone: f32 (3xTF32, ~165 TFLOP/s) 0.156 ms against
// 0.046 ms for 151 MB of q, k, v, dO, dK, dV, L, D: operation-bound; bf16
// 0.026 ms at 989 TFLOP/s against 0.023 ms for 76 MB: operation-bound by
// a hair.
//
// dQ kernel (FMA loops, as designed in the training slice; the next to be
// redesigned): one block per (b*h, 64-row q tile), kv streamed through
// shared memory in 32-row tiles up to the diagonal's tile when causal; the
// q tiles with the most causal work are scheduled first.  It computes D
// for its rows from dO and O and also writes D as a (B*H, T) f32 side
// output: 4 bytes a row, where the TPU's dK/dV kernel recomputes D for
// every (kv tile, q tile) pair (:271).  Each row is split over
// neighbouring threads of one warp, 32 head dims a thread (one thread at
// D <= 32, two at D = 64, four at D = 128), each holding its slice of q,
// dO and dQ in f32 registers and summing dot products with shuffles, two
// streamed rows at a time; the split and the group size came from a sweep
// of 18 variants.
// Runs on the FMA units in both types, so its ceiling is the f32 FMA peak.
//
// dK/dV kernel, on mma.sync (flash_tile.cuh gives the atoms, the swizzled
// shared memory and the copies): one block per (b*h, 64-row kv tile),
// early kv tiles (the most causal work) first; four warps, each owning 16
// kv rows.  K and V fragments stay in registers in bf16 up to D = 64, and
// are re-read from shared memory per k-step otherwise (the 3xTF32 pairs
// of both, beside the dK and dV accumulators, would spill).  Q, dO, L and
// D stream through a two-stage cp.async ring in 64-row q tiles (32 at
// D = 128), from the tile's first row k0 when causal (no row above k0
// sees these keys) to T.  Per q tile and warp, all in f32 accumulators:
// S^T = K.Q^T and dP^T = V.dO^T; P^T = exp(S^T - L), masked only in tiles
// that cross the diagonal or the ragged tail; dS^T = P^T (dP^T - D) scale;
// then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T converted in
// registers into A operands (rounded to bf16 there in bf16).  Rows >= T
// are loaded as zeros by the copies and never stored.  Tiles:
// tools/sweep_flash_bwd.py varies kDkvBlockQ and kDkvStages.

#include "flash_tile.cuh"

namespace {

using flash::Elem;
using flash::kNeg;
using flash::kZeroBelow;

// dQ kernel
constexpr int kTile = 32;   // streamed rows per shared-memory tile
constexpr int kGroup = 2;   // streamed rows whose dot products run together
constexpr int kDqDims = 32; // head dims a thread holds

// dK/dV kernel
constexpr int kDkvBlockN = 64;  // kv rows per block, 16 per warp
constexpr int kDkvBlockQ = 64;  // q rows per ring stage (at most 32 at D = 128)
constexpr int kDkvStages = 2;   // ring depth

template <int D, int kMaxDims>
struct Cfg {
  static constexpr int kDimsPerThread = D < kMaxDims ? D : kMaxDims;
  static constexpr int kThreadsPerRow = D / kDimsPerThread;
  // q rows per block: 64, fewer where that would take more than 256
  // threads
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
struct DkvCfg {
  static constexpr int kWarps = kDkvBlockN / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBQ = D > 64 && kDkvBlockQ > 32 ? 32 : kDkvBlockQ;
  static constexpr bool kKVInRegs = sizeof(T) == 2 && D <= 64;
  static constexpr int kKVElems = kDkvBlockN * D;
  static constexpr int kQElems = kBQ * D;
  // a ring stage: the Q tile, the dO tile, then kBQ values of L and of D
  static constexpr int kStageBytes =
      static_cast<int>(2 * kQElems * sizeof(T)) + 2 * kBQ * 4;
  static constexpr int bytes(int stages) {
    return static_cast<int>(2 * kKVElems * sizeof(T)) + stages * kStageBytes;
  }
  // two stages where a deeper ring would not fit the 227 KB of a block
  static constexpr int kStages =
      bytes(kDkvStages) <= 232448 ? kDkvStages : 2;
  static constexpr int kSmemBytes = bytes(kStages);
  static_assert(kDkvBlockN % kBQ == 0, "causal q tiles start at k0");
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<T, D>::kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lse,
                 const T* __restrict__ dout, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int seq, float scale,
                 int causal) {
  using At = flash::Atom<T>;
  using E = Elem<T>;
  using C = DkvCfg<T, D>;
  constexpr int BN = kDkvBlockN, BQ = C::kBQ, S = C::kStages;
  constexpr int NB = BQ / 8;          // 8-column blocks of S^T and dP^T
  constexpr int KS = D / At::kK;      // k-steps of K.Q^T and V.dO^T
  constexpr int DB = D / 8;           // 8-column blocks of dK and dV
  constexpr int PK = BQ / At::kK;     // k-steps of P^T.dO and dS^T.Q
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ksm = reinterpret_cast<T*>(smem_raw);
  T* vsm = ksm + C::kKVElems;
  unsigned char* ring = smem_raw + 2 * C::kKVElems * sizeof(T);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr0 = warp * 16;                  // the warp's rows in the tile
  const int kr[2] = {k0 + wr0 + (lane >> 2), k0 + wr0 + (lane >> 2) + 8};
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t lbase = static_cast<size_t>(bh) * seq;
  const int r_begin = causal ? k0 : 0;
  const int n_tiles = (seq - r_begin + BQ - 1) / BQ;

  flash::load_tile<T, BN, D, C::kThreads>(ksm, k + base, k0, seq);
  flash::load_tile<T, BN, D, C::kThreads>(vsm, v + base, k0, seq);
  auto prefetch = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = ring + (it % S) * C::kStageBytes;
      T* qt = reinterpret_cast<T*>(st);
      float* lv = reinterpret_cast<float*>(st + 2 * C::kQElems * sizeof(T));
      const int r0 = r_begin + it * BQ;
      flash::load_tile<T, BQ, D, C::kThreads>(qt, q + base, r0, seq);
      flash::load_tile<T, BQ, D, C::kThreads>(qt + C::kQElems, dout + base,
                                              r0, seq);
      flash::load_vec<BQ, C::kThreads>(lv, lse + lbase, r0, seq);
      flash::load_vec<BQ, C::kThreads>(lv + BQ, delta + lbase, r0, seq);
    }
    flash::cp_async_commit();   // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) prefetch(s);

  typename At::A kf[C::kKVInRegs ? KS : 1], vf[C::kKVInRegs ? KS : 1];
  float dka[DB][4], dva[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;
  const bool warp_live = k0 + wr0 < seq;

  for (int it = 0; it < n_tiles; ++it) {
    prefetch(it + S - 1);
    flash::cp_async_wait<S - 1>();
    __syncthreads();
    if constexpr (C::kKVInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          At::template load_a<D>(ksm, wr0, kk * At::kK, kf[kk]);
          At::template load_a<D>(vsm, wr0, kk * At::kK, vf[kk]);
        }
      }
    }
    const int r0 = r_begin + it * BQ;
    if (warp_live && !(causal && r0 + BQ - 1 < k0 + wr0)) {
      const unsigned char* st = ring + (it % S) * C::kStageBytes;
      const T* qs = reinterpret_cast<const T*>(st);
      const T* gs = qs + C::kQElems;
      const float* ls =
          reinterpret_cast<const float*>(st + 2 * C::kQElems * sizeof(T));
      const float* ds = ls + BQ;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        typename At::A ktmp, vtmp;
        if constexpr (!C::kKVInRegs) {
          At::template load_a<D>(ksm, wr0, kk * At::kK, ktmp);
          At::template load_a<D>(vsm, wr0, kk * At::kK, vtmp);
        }
        const int ki = C::kKVInRegs ? kk : 0;
        const typename At::A& ka = C::kKVInRegs ? kf[ki] : ktmp;
        const typename At::A& va = C::kKVInRegs ? vf[ki] : vtmp;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          typename At::B b;
          At::template load_b_nk<D>(qs, nb * 8, kk * At::kK, b);
          At::mma(s[nb], ka, b);
          At::template load_b_nk<D>(gs, nb * 8, kk * At::kK, b);
          At::mma(dp[nb], va, b);
        }
      }

      // Tiles that cross the diagonal or the ragged tail mask element by
      // element in natural units.  The others fold the scale into the
      // exponent's FMA, p = 2^(s scale log2 e - L log2 e); the zeroing of
      // p where s <= -5e29 can only bite where L is that low too
      // (otherwise exp underflows to 0 anyway), so they check it only then.
      const bool need_mask =
          r0 + BQ > seq || (causal && r0 < k0 + wr0 + 15);
      bool low = false;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        low |= ls[nb * 8 + 2 * t] <= kZeroBelow ||
               ls[nb * 8 + 2 * t + 1] <= kZeroBelow;
      if (need_mask || __any_sync(0xffffffffu, low)) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = nb * 8 + 2 * t + (e & 1);
            const int qp = r0 + i;
            float x = s[nb][e] * scale;
            if (need_mask && (qp >= seq || (causal && qp < kr[e >> 1])))
              x = kNeg;
            const float p = x <= kZeroBelow
                                ? 0.f
                                : flash::exp_from(x, ls[i] * flash::kLog2e);
            s[nb][e] = p;
            dp[nb][e] = p * (dp[nb][e] - ds[i]) * scale;
          }
      } else {
        const float sl = scale * flash::kLog2e;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = nb * 8 + 2 * t + (e & 1);
            const float p = flash::exp2_of(
                fmaf(s[nb][e], sl, -ls[i] * flash::kLog2e));
            s[nb][e] = p;
            dp[nb][e] = p * (dp[nb][e] - ds[i]) * scale;
          }
      }
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        typename At::A pa, da;
        At::a_from_c(s, kk, pa);
        At::a_from_c(dp, kk, da);
#pragma unroll
        for (int db = 0; db < DB; ++db) {
          typename At::B b;
          At::template load_b_kn<D>(gs, kk * At::kK, db * 8, b);
          At::mma(dva[db], pa, b);
          At::template load_b_kn<D>(qs, kk * At::kK, db * 8, b);
          At::mma(dka[db], da, b);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  if (warp_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kr[r] >= seq) continue;
      const size_t off = base + static_cast<size_t>(kr[r]) * D + 2 * t;
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        E::store2(dk + off + db * 8, dka[db][2 * r], dka[db][2 * r + 1]);
        E::store2(dv + off + db * 8, dva[db][2 * r], dva[db][2 * r + 1]);
      }
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
  using C = DkvCfg<T, D>;
  const int tiles = (a.seq + kDkvBlockN - 1) / kDkvBlockN;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_dkv_kernel<T, D>;
  if (int rc = flash::allow_smem(kernel, C::kSmemBytes)) return rc;
  kernel<<<dim3(a.bh, tiles), C::kThreads, C::kSmemBytes, a.stream>>>(
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
