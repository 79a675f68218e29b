// FlashAttention-2 forward for Hopper (sm_90a) on tensor cores, with a
// plain C interface.
//
// Replaces mxnet_tpu/ops/pallas_attention.py::_fwd_kernel (:78-131), which
// _flash_call (:142-185) launches through pl.pallas_call.
//
// What it computes, per (b*h) and query row i over keys j (Tq == Tk;
// causal keeps j <= i, the top-left square mask of the TPU kernel):
//   s_ij = (q_i . k_j) * scale with f32 accumulation;
//   an online softmax over kv tiles with m, l and the O accumulator in f32;
//   masked scores are -1e30 and probabilities where s <= -5e29 are zeroed;
//   in bf16, p is rounded to bf16 before P.V, as p.astype(v.dtype) does;
//   O = acc / l (l == 0 counts as 1) and LSE = m + log l, so a fully
//   masked row gives O = 0 and LSE = -1e30.
//
// Layout: q, k, v and O are contiguous (B*H, T, D), D in {16, 32, 64, 128},
// f32 or bf16, 16-byte aligned; LSE is (B*H, T) f32.  The Python wrapper
// makes q, k and v contiguous and aligned and allocates O and LSE; this
// file allocates nothing and never synchronises.
//
// Bound at the training shape (B=8, H=12, T=1024, D=64, causal), reckoned
// from shapes: 50.4 M visible (query, key) pairs at 4*D flops a pair =
// 12.9 GFLOP; q, k, v read once and O, LSE written once = 50.7 MB in bf16,
// 101 MB in f32.  bf16: 13 us of tensor-core time at 989 TFLOP/s against
// 15 us at 3.35 TB/s, so bytes-bound.  f32 (3xTF32, ~165 TFLOP/s): 78 us
// against 30 us of traffic, so operation-bound.
//
// Design: FlashAttention-2 on mma.sync (flash_tile.cuh gives the atoms, the
// swizzled shared memory and the copies).  One block per (b*h, 128-row q
// tile), q tiles with the most causal work first; eight warps, each owning
// 16 q rows whose Q fragments are loaded once into registers (re-read from
// shared memory per k-step for f32 at D = 128, where the 3xTF32 pairs would
// not fit beside O).  K and V tiles of 64 rows stream through a two-stage
// cp.async ring, so the next tile loads while this one multiplies.  Per
// tile and warp: S = Q.K^T into f32 accumulators; the mask, element by
// element, only in tiles that cross the diagonal or the ragged tail (tiles
// above the diagonal are never loaded, and a warp skips the tiles that lie
// wholly above its rows); the online softmax on the accumulator fragments
// (row max and sum over a lane quad by two shuffles, l summed per lane and
// reduced once at the end, exp as one FMA and one EX2 with the scale
// folded in); P converted in registers into the A operand of P.V (rounded
// to bf16 there in bf16); O accumulated in f32 registers.  (Issuing tile j + 1's Q.K^T before tile
// j's softmax, a software pipeline across tiles, measured slower: it needs
// a second score tile in registers and a third stage.)  Tiles:
// tools/sweep_flash_bwd.py varies kFwdBlockM, kFwdBlockN, kFwdStages and
// kFwdQRegsF32.

#include "flash_tile.cuh"

namespace {

using flash::kNeg;
using flash::kZeroBelow;

constexpr int kFwdBlockM = 128;  // q rows per block, 16 per warp
constexpr int kFwdBlockN = 64;   // kv rows per ring stage
constexpr int kFwdStages = 2;    // ring depth
constexpr int kFwdQRegsF32 = 64; // f32 keeps Q fragments in registers up to
                                 // this head dim, re-reads them above it

template <typename T, int D>
struct FwdCfg {
  static constexpr int kWarps = kFwdBlockM / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr bool kQInRegs = sizeof(T) == 2 || D <= kFwdQRegsF32;
  static constexpr int kQElems = kFwdBlockM * D;
  static constexpr int kKVElems = kFwdBlockN * D;
  static constexpr int bytes(int stages) {
    return static_cast<int>((kQElems + 2 * stages * kKVElems) * sizeof(T));
  }
  // two stages where a deeper ring would not fit the 227 KB of a block
  static constexpr int kStages = bytes(kFwdStages) <= 232448 ? kFwdStages : 2;
  static constexpr int kSmemBytes = bytes(kStages);
  static_assert(kSmemBytes <= 232448, "the ring fits a block");
};

// The two products of one warp (16 q rows) with one kv tile.
template <typename T, int D>
struct FwdWarp {
  using At = flash::Atom<T>;
  using C = FwdCfg<T, D>;
  static constexpr int NB = kFwdBlockN / 8;   // 8-column blocks of S
  static constexpr int KS = D / At::kK;   // k-steps of Q.K^T
  static constexpr int DB = D / 8;        // 8-column blocks of O
  static constexpr int PK = kFwdBlockN / At::kK;   // k-steps of P.V
  static constexpr int kQFrags = C::kQInRegs ? KS : 1;

  // s = Q.K^T (raw dot products) from Q fragments in registers (qf) or
  // shared memory (qs), K from the stage ks
  static __device__ __forceinline__ void scores(
      float (&s)[NB][4], const typename At::A (&qf)[kQFrags], const T* qs,
      int wr0, const T* ks) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      typename At::A tmp;
      if constexpr (!C::kQInRegs)
        At::template load_a<D>(qs, wr0, kk * At::kK, tmp);
      const typename At::A& a = C::kQInRegs ? qf[C::kQInRegs ? kk : 0] : tmp;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        typename At::B b;
        At::template load_b_nk<D>(ks, nb * 8, kk * At::kK, b);
        At::mma(s[nb], a, b);
      }
    }
  }

  // acc += P.V, P in registers, V from the stage vs
  static __device__ __forceinline__ void pv(float (&acc)[DB][4],
                                            const float (&p)[NB][4],
                                            const T* vs) {
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      typename At::A pa;
      At::a_from_c(p, kk, pa);
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        typename At::B b;
        At::template load_b_kn<D>(vs, kk * At::kK, db * 8, b);
        At::mma(acc[db], pa, b);
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<T, D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, float scale, int causal) {
  using W = FwdWarp<T, D>;
  using At = flash::Atom<T>;
  using E = flash::Elem<T>;
  using C = FwdCfg<T, D>;
  constexpr int BM = kFwdBlockM, BN = kFwdBlockN, S = C::kStages;
  constexpr int NB = W::NB, DB = W::DB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + C::kQElems;   // stage s: K at kvs + 2 s kKVElems, V after
  auto k_stage = [&](int it) { return kvs + (it % S) * 2 * C::kKVElems; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr0 = warp * 16;                  // the warp's rows in the tile
  const int row[2] = {q0 + wr0 + (lane >> 2), q0 + wr0 + (lane >> 2) + 8};
  const size_t base = static_cast<size_t>(bh) * seq * D;

  const int kv_end = causal ? min(seq, q0 + BM) : seq;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // kv tiles [0, n_act) hold a key some row of this warp may see
  const int n_act = q0 + wr0 >= seq ? 0
                    : causal ? min(n_tiles, (q0 + wr0 + 15) / BN + 1)
                             : n_tiles;

  flash::load_tile<T, BM, D, C::kThreads>(qs, q + base, q0, seq);
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

  typename At::A qf[W::kQFrags];
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // Tile it: S = Q.K^T, the online softmax, O += P.V.
  auto step = [&](int it) {
    const int k0 = it * BN;
    float s[NB][4];
    W::scores(s, qf, qs, wr0, k_stage(it));

    // Tiles that cross the diagonal or the ragged tail take scores to
    // natural units and mask them element by element.  The others keep
    // raw dot products: max(s) * scale is the maximum of the scaled scores
    // (rounding is monotonic), and p = 2^(s scale log2 e - m log2 e) folds
    // the scale into the exponent's FMA.  The zeroing of p where
    // s <= -5e29 can only bite where a row's maximum is that low too
    // (otherwise exp underflows to 0 anyway), so the unmasked path checks
    // it only then.
    const bool need_mask =
        k0 + BN > seq || (causal && k0 + BN - 1 > q0 + wr0);
    float mt[2] = {kNeg, kNeg};
    if (need_mask) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nb * 8 + 2 * t + (e & 1);
          float x = s[nb][e] * scale;
          if (kp >= seq || (causal && kp > row[e >> 1])) x = kNeg;
          s[nb][e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mt[e >> 1] = fmaxf(mt[e >> 1], s[nb][e]);
      mt[0] *= scale;
      mt[1] *= scale;
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], flash::quad_max(mt[h]));
      alpha[h] = flash::exp_from(m[h], mn * flash::kLog2e);
      m[h] = mn;
      mb[h] = mn * flash::kLog2e;
      l[h] *= alpha[h];
    }
    if (need_mask ||
        __any_sync(0xffffffffu, m[0] <= kZeroBelow || m[1] <= kZeroBelow)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = need_mask ? s[nb][e] : s[nb][e] * scale;
          const float p =
              x <= kZeroBelow ? 0.f : flash::exp_from(x, mb[e >> 1]);
          l[e >> 1] += p;
          s[nb][e] = p;
        }
    } else {
      const float sl = scale * flash::kLog2e;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = flash::exp2_of(fmaf(s[nb][e], sl, -mb[e >> 1]));
          l[e >> 1] += p;
          s[nb][e] = p;
        }
    }
#pragma unroll
    for (int db = 0; db < DB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[db][e] *= alpha[e >> 1];

    W::pv(acc, s, k_stage(it) + C::kKVElems);
  };
  for (int it = 0; it < n_tiles; ++it) {
    prefetch(it + S - 1);
    flash::cp_async_wait<S - 1>();   // tile it (and Q) have landed ...
    __syncthreads();                 // ... for every thread
    if constexpr (C::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < W::KS; ++kk)
          At::template load_a<D>(qs, wr0, kk * At::kK, qf[kk]);
      }
    }
    if (it < n_act) step(it);
    __syncthreads();   // every warp is done with this stage
  }

  if (n_act > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lsum = flash::quad_sum(l[h]);
      if (row[h] >= seq) continue;
      const float lsafe = lsum == 0.f ? 1.f : lsum;
      T* orow = o + base + static_cast<size_t>(row[h]) * D + 2 * t;
#pragma unroll
      for (int db = 0; db < DB; ++db)
        E::store2(orow + db * 8, acc[db][2 * h] / lsafe,
                  acc[db][2 * h + 1] / lsafe);
      if (t == 0)
        lse[static_cast<size_t>(bh) * seq + row[h]] = m[h] + logf(lsafe);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int seq, int causal, float scale, cudaStream_t stream) {
  using C = FwdCfg<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  if (int rc = flash::allow_smem(kernel, C::kSmemBytes)) return rc;
  const dim3 grid(bh, (seq + kFwdBlockM - 1) / kFwdBlockM);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* o, void* lse, int bh, int seq, int causal, float scale,
             cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, seq, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, seq, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, seq, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, seq, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t: 0 on a
// successful launch, cudaErrorInvalidValue for a shape or type it does
// not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int seq, int head_dim, int dtype,
                                   int causal, float scale, void* stream) {
  if (bh < 1 || seq < 1 || (seq + kFwdBlockM - 1) / kFwdBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(head_dim, q, k, v, o, lse, bh, seq, causal, scale, st);
    case 1:
      return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, lse, bh, seq, causal,
                                     scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
