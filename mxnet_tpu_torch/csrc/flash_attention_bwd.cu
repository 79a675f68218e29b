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
// does 14*D (S and dP in both kernels), of which dQ 6*D (19.4 GFLOP) and
// dK/dV 8*D (25.8 GFLOP).  dQ alone: f32 (3xTF32, ~165 TFLOP/s) 0.117 ms
// against 0.045 ms for 151 MB of q, k, v, O, dO, dQ, L, D:
// operation-bound; bf16 0.020 ms at 989 TFLOP/s against 0.023 ms for
// 76 MB: bytes-bound by a hair.  dK/dV alone: f32 0.156 ms against
// 0.046 ms for 151 MB of q, k, v, dO, dK, dV, L, D: operation-bound; bf16
// 0.026 ms against 0.023 ms for 76 MB: operation-bound by a hair.
//
// Both kernels run on mma.sync (flash_tile.cuh gives the atoms, the
// swizzled shared memory and the copies) into f32 accumulators, bf16
// products directly and f32 ones as 3xTF32; each mirrors the other with
// the roles of q and kv swapped.
//
// dQ kernel: one block per (b*h, 64-row q tile), the q tiles with the most
// causal work first; four warps, each owning 16 q rows.  Q and dO tiles
// land once in swizzled shared memory; their fragments stay in registers
// in bf16 up to D = 64 and are re-read per k-step otherwise (the 3xTF32
// pairs of both, beside the dQ accumulator, would spill).  While they land
// each lane quad computes D = rowsum(dO * O) in f32 for the two rows its
// accumulator holds (16-byte loads of dO and O, summed over the quad), and
// writes it as a (B*H, T) f32 side output: 4 bytes a row, where the TPU's
// dK/dV kernel recomputes D for every (kv tile, q tile) pair (:271).  L
// and D stay in registers by accumulator row.  K and V stream through a
// two-stage cp.async ring in 64-row kv tiles (32 at D = 128) up to the
// diagonal's tile when causal; a warp skips the tiles wholly above its
// rows.  Per kv tile and warp: S = Q.K^T and dP = dO.V^T; P = exp(S - L),
// masked only in tiles that cross the diagonal or the ragged tail;
// dS = P (dP - D) scale; dQ += dS.K with dS converted in registers into
// the A operand (rounded to bf16 there in bf16) and K read down its rows.
// dQ is stored from the accumulator; each output row has one writer.
//
// dK/dV kernel: one block per (b*h, 64-row kv tile),
// early kv tiles (the most causal work) first; four warps, each owning 16
// kv rows.  K and V fragments stay in registers in bf16 up to D = 64, and
// are re-read from shared memory per k-step otherwise (the 3xTF32 pairs
// of both, beside the dK and dV accumulators, would spill).  Q, dO, L and
// D stream through a two-stage cp.async ring in 64-row q tiles (32 at
// D = 128), from the tile's first row k0 when causal (no row above k0
// sees these keys) to T.  Per q tile and warp:
// S^T = K.Q^T and dP^T = V.dO^T; P^T = exp(S^T - L), masked only in tiles
// that cross the diagonal or the ragged tail; dS^T = P^T (dP^T - D) scale;
// then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T converted in
// registers into A operands (rounded to bf16 there in bf16).  Rows >= T
// are loaded as zeros by the copies and never stored.
//
// Tiles: tools/sweep_flash_bwd.py varies kDqBlockM, kDqBlockN, kDqStages,
// kDkvBlockQ and kDkvStages.

#include "flash_tile.cuh"

namespace {

using flash::Elem;
using flash::kNeg;
using flash::kZeroBelow;

// dQ kernel
constexpr int kDqBlockM = 64;   // q rows per block, 16 per warp
constexpr int kDqBlockN = 64;   // kv rows per ring stage (at most 32 at D = 128)
constexpr int kDqStages = 2;    // ring depth

// dK/dV kernel
constexpr int kDkvBlockN = 64;  // kv rows per block, 16 per warp
constexpr int kDkvBlockQ = 64;  // q rows per ring stage (at most 32 at D = 128)
constexpr int kDkvStages = 2;   // ring depth

template <typename T, int D>
struct DqCfg {
  static constexpr int kWarps = kDqBlockM / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBN = D > 64 && kDqBlockN > 32 ? 32 : kDqBlockN;
  static constexpr bool kQInRegs = sizeof(T) == 2 && D <= 64;
  static constexpr int kQElems = kDqBlockM * D;
  static constexpr int kKVElems = kBN * D;
  // the Q and dO tiles, then the ring: K then V in each stage
  static constexpr int kSmemBytes = static_cast<int>(
      (2 * kQElems + 2 * kDqStages * kKVElems) * sizeof(T));
  static_assert(kSmemBytes <= 232448, "the tiles fit the 227 KB of a block");
};

// acc + the dot product of two 16-byte chunks of T, in f32.
template <typename T>
__device__ __forceinline__ float chunk_dot(uint4 a, uint4 b, float acc);

template <>
__device__ __forceinline__ float chunk_dot<float>(uint4 a, uint4 b,
                                                  float acc) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

template <>
__device__ __forceinline__ float chunk_dot<__nv_bfloat16>(uint4 a, uint4 b,
                                                          float acc) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 y =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<T, D>::kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dq, float* __restrict__ delta, int seq,
                float scale, int causal) {
  using At = flash::Atom<T>;
  using E = Elem<T>;
  using C = DqCfg<T, D>;
  using Lay = flash::Layout<T, D>;
  constexpr int BM = kDqBlockM, BN = C::kBN, S = kDqStages;
  constexpr int NB = BN / 8;          // 8-column blocks of S and dP
  constexpr int KS = D / At::kK;      // k-steps of Q.K^T and dO.V^T
  constexpr int DB = D / 8;           // 8-column blocks of dQ
  constexpr int PK = BN / At::kK;     // k-steps of dS.K
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + C::kQElems;
  T* kvs = gs + C::kQElems;   // stage s: K at kvs + 2 s kKVElems, V after
  auto k_stage = [&](int it) { return kvs + (it % S) * 2 * C::kKVElems; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr0 = warp * 16;                  // the warp's rows in the tile
  const int row[2] = {q0 + wr0 + (lane >> 2), q0 + wr0 + (lane >> 2) + 8};
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t lbase = static_cast<size_t>(bh) * seq;

  const int kv_end = causal ? min(seq, q0 + BM) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // kv tiles [0, n_act) hold a key some row of this warp may see
  const int n_act = q0 + wr0 >= seq ? 0
                    : causal ? min(n_tiles, (q0 + wr0 + 15) / BN + 1)
                             : n_tiles;

  flash::load_tile<T, BM, D, C::kThreads>(qs, q + base, q0, seq);
  flash::load_tile<T, BM, D, C::kThreads>(gs, dout + base, q0, seq);
  auto prefetch = [&](int it) {
    if (it < n_tiles) {
      T* st = k_stage(it);
      flash::load_tile<T, BN, D, C::kThreads>(st, k + base, it * BN, seq);
      flash::load_tile<T, BN, D, C::kThreads>(st + C::kKVElems, v + base,
                                              it * BN, seq);
    }
    flash::cp_async_commit();   // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) prefetch(s);

  // While the copies fly: D = rowsum(dO * O) for rows g and g + 8 of the
  // lane's accumulator (the quad's four lanes take every fourth 16-byte
  // chunk of the row and sum over the quad), written once by lane t = 0;
  // L, in log2 units, for the same rows.  Rows >= T keep D = L = 0.
  float dl[2], lb[2];
  bool low = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = row[h] < seq;
    float acc = 0.f;
    if (live) {
      const size_t off = base + static_cast<size_t>(row[h]) * D;
      const uint4* gr = reinterpret_cast<const uint4*>(dout + off);
      const uint4* orow = reinterpret_cast<const uint4*>(o + off);
#pragma unroll
      for (int c0 = 0; c0 < Lay::kChunks; c0 += 4)
        if (c0 + t < Lay::kChunks)
          acc = chunk_dot<T>(gr[c0 + t], orow[c0 + t], acc);
    }
    dl[h] = flash::quad_sum(acc);
    if (live && t == 0) delta[lbase + row[h]] = dl[h];
    const float lr = live ? lse[lbase + row[h]] : 0.f;
    low |= lr <= kZeroBelow;
    lb[h] = lr * flash::kLog2e;
  }
  low = __any_sync(0xffffffffu, low);

  typename At::A qf[C::kQInRegs ? KS : 1], gf[C::kQInRegs ? KS : 1];
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;

  // Tile it: S = Q.K^T and dP = dO.V^T, dS, dQ += dS.K.
  auto step = [&](int it) {
    const int k0 = it * BN;
    const T* ks = k_stage(it);
    const T* vs = ks + C::kKVElems;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      typename At::A qtmp, gtmp;
      if constexpr (!C::kQInRegs) {
        At::template load_a<D>(qs, wr0, kk * At::kK, qtmp);
        At::template load_a<D>(gs, wr0, kk * At::kK, gtmp);
      }
      const int qi = C::kQInRegs ? kk : 0;
      const typename At::A& qa = C::kQInRegs ? qf[qi] : qtmp;
      const typename At::A& ga = C::kQInRegs ? gf[qi] : gtmp;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        typename At::B b;
        At::template load_b_nk<D>(ks, nb * 8, kk * At::kK, b);
        At::mma(s[nb], qa, b);
        At::template load_b_nk<D>(vs, nb * 8, kk * At::kK, b);
        At::mma(dp[nb], ga, b);
      }
    }

    // Tiles that cross the diagonal or the ragged tail mask element by
    // element in natural units.  The others fold the scale into the
    // exponent's FMA, p = 2^(s scale log2 e - L log2 e); the zeroing of p
    // where s <= -5e29 can only bite where L is that low too (otherwise
    // exp underflows to 0 anyway), so they check it only then.
    const bool need_mask =
        k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr0);
    if (need_mask || low) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nb * 8 + 2 * t + (e & 1);
          float x = s[nb][e] * scale;
          if (need_mask && (kp >= seq || (causal && kp > row[e >> 1])))
            x = kNeg;
          const float p =
              x <= kZeroBelow ? 0.f : flash::exp_from(x, lb[e >> 1]);
          dp[nb][e] = p * (dp[nb][e] - dl[e >> 1]) * scale;
        }
    } else {
      const float sl = scale * flash::kLog2e;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = flash::exp2_of(fmaf(s[nb][e], sl, -lb[e >> 1]));
          dp[nb][e] = p * (dp[nb][e] - dl[e >> 1]) * scale;
        }
    }
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      typename At::A da;
      At::a_from_c(dp, kk, da);
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        typename At::B b;
        At::template load_b_kn<D>(ks, kk * At::kK, db * 8, b);
        At::mma(acc[db], da, b);
      }
    }
  };
  for (int it = 0; it < n_tiles; ++it) {
    prefetch(it + S - 1);
    flash::cp_async_wait<S - 1>();   // tile it (and Q, dO) have landed ...
    __syncthreads();                 // ... for every thread
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          At::template load_a<D>(qs, wr0, kk * At::kK, qf[kk]);
          At::template load_a<D>(gs, wr0, kk * At::kK, gf[kk]);
        }
      }
    }
    if (it < n_act) step(it);
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq) continue;
    T* out = dq + base + static_cast<size_t>(row[h]) * D + 2 * t;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      E::store2(out + db * 8, acc[db][2 * h], acc[db][2 * h + 1]);
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
  using C = DqCfg<T, D>;
  const int tiles = (a.seq + kDqBlockM - 1) / kDqBlockM;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_dq_kernel<T, D>;
  if (int rc = flash::allow_smem(kernel, C::kSmemBytes)) return rc;
  kernel<<<dim3(a.bh, tiles), C::kThreads, C::kSmemBytes, a.stream>>>(
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
