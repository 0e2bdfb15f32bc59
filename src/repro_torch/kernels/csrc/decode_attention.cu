// Flash-decode attention of one query token over a KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (launched by decode_attention_kernel).  Same function: q (B, 1, Hq, hd)
// over k/v (B, L, Hkv, hd) valid to kv_len[b] (a device int32 (B,) vector;
// the wrapper broadcasts a scalar), clamped to [0, L]; GQA kv head =
// hq / rep; softmax with f32 max, denominator and accumulator, denominator
// clamped at 1e-30 (kv_len = 0 gives 0); O in the input dtype.
//
// What bounds it on the H100: bytes.  Each cache entry up to kv_len is used
// for 2 FLOPs per query head of its group, far below the card's ridge point,
// so the least time is (K + V bytes up to kv_len) / 3.35 TB/s.  One serving
// round reads ~10 MB: the time goes to latency unless the whole card has
// copies in flight at once.  The design splits the sequence over a thread
// block cluster, in one launch and with no workspace (decode_kernel):
//  * a cluster of kCluster = 8 CTAs (the portable size) per (b, kv head,
//    group of up to R query heads: R is 1, 2, 4 or 8, the least that holds
//    the GQA group, groups of 8 past that).  CTA rank r takes one contiguous
//    span of [0, kv_len[b]): ceil(kv_len / 8) keys rounded up to the box,
//    read on the device from kv_len (tile_walk.decode_spans); a rank whose
//    span is empty contributes (m, s, acc) = (-inf, 0, 0);
//  * the span streams through TMA boxes of kBox = 32 keys of K and V (tensor
//    maps over the (B, L, Hkv, hd) cache, in HeadLayout's swizzle, so the
//    thread-per-key reads of a box are free of bank conflicts).  Each of W
//    warps owns one stage of the ring (a K and a V slot, each with its
//    "full" mbarrier) and takes boxes w, w + W, ...: every warp's first box
//    is in flight at once, and a warp refills each slot as soon as it has
//    read it (K after the scores, V after P.V), so box i's softmax and P.V
//    run under the loads of the boxes after it.  W is as many stages as 72
//    KB hold, 2 to 8 (4 at hd 128 in bf16: three CTAs fit on an SM, so
//    every cluster of a serving round is resident at once).  The query
//    heads of the group share each box;
//  * lane j scores key j of the box against each query head (q staged in
//    f32, pre-scaled by scale*log2e, so scores are in log2 units); keys at
//    and past kv_len are selected as -inf, and in a box that holds such keys
//    their V rows are zeroed first (the cache past kv_len may hold anything,
//    and 0 * NaN is NaN), so P.V runs over the whole box, unrolled.  Each
//    warp keeps its own online softmax: m (warp max per box), this lane's
//    part of s, and acc over the dims d = 4*lane + 128*g that the lane owns
//    in P.V, with P broadcast from shared memory;
//  * the CTA merges its warps in order into its state (m, s, acc[hd]) per
//    query head in shared memory (the warps' states where the stages were).
//    After a cluster barrier, rank r writes dims [r*hd/8, (r+1)*hd/8) of
//    each head, reading the 8 ranks' states through distributed shared
//    memory in rank order (key order): M = max m_r, O = sum acc_r 2^(m_r -
//    M) / max(sum s_r 2^(m_r - M), 1e-30).  A second cluster barrier keeps
//    every CTA alive until its shared memory has been read.
// The box walk is on the CUDA cores: the tensor cores' products save little
// here, since a call is bound by the latency of its loads and barriers, not
// by its arithmetic.
// Every output is written by one thread in a fixed order, with no atomics:
// two calls on the same inputs agree bit for bit.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;

constexpr int kCluster = 8;             // CTAs per (b, kv head, query-head group)
constexpr int kBox = 32;                // keys per TMA box: lane j <-> key j
constexpr int kStageBudget = 72 * 1024; // bytes of K/V boxes in flight per CTA

// Shared memory: W stages of a K and a V box (after the walk, the warps'
// states acc [W][R][HD] and the CTA's acc [R][HD], f32), then f32: q rows
// [R][HD], the warps' probabilities [W][R][kBox] and (m, s) [W][R][2], the
// CTA's (m, s) [R][2]; then the barriers.
template <typename T, int HD, int R>
struct DecodeSmem {
  using L = sm90::HeadLayout<HD, T>;
  static constexpr int kBoxBytes = L::template tile_bytes<kBox>();
  // warps, one ring stage (a K and a V box) each
  static constexpr int W = kStageBudget / (2 * kBoxBytes) < 2   ? 2
                           : kStageBudget / (2 * kBoxBytes) > 8 ? 8
                                                                 : kStageBudget / (2 * kBoxBytes);
  static constexpr int kK = 0;
  static constexpr int kV = W * kBoxBytes;
  static constexpr int kWAcc = 0;
  static constexpr int kAcc = W * R * HD * 4;
  static_assert((W + 1) * R * HD * 4 <= 2 * W * kBoxBytes, "the states fit in the stages");
  static constexpr int kQ = 2 * W * kBoxBytes;
  static constexpr int kP = kQ + R * HD * 4;
  static constexpr int kWMs = kP + W * R * kBox * 4;
  static constexpr int kMs = kWMs + W * R * 8;
  static constexpr int kBars = kMs + R * 8;
  static constexpr size_t kBytes = kBars + 16 * W + 1024;
};

// 16 bytes of shared memory widened to floats (8 bf16 or 4 f32)
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

template <typename T, int HD, int R>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(32 * DecodeSmem<T, HD, R>::W)
decode_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const T* __restrict__ q, const int* __restrict__ kv_len, T* __restrict__ o,
              int n_heads, int rep, int n_groups, int n_kv, int L, int64_t q_sb, int64_t o_sb,
              float scale_log2) {
  using S = DecodeSmem<T, HD, R>;
  using Lay = sm90::HeadLayout<HD, T>;
  constexpr int W = S::W;
  constexpr int kThreads = 32 * W;
  constexpr int VEC = 16 / int(sizeof(T));   // elements per 16-byte chunk
  constexpr int NG = (HD + 127) / 128;       // 4-dim groups per lane in P.V: d = 4*lane + 128*g
  constexpr int DPR = HD / kCluster;         // output dims per rank
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  float* qs = reinterpret_cast<float*>(sm + S::kQ);
  float* wacc = reinterpret_cast<float*>(sm + S::kWAcc);
  float* wms = reinterpret_cast<float*>(sm + S::kWMs);
  float* cacc = reinterpret_cast<float*>(sm + S::kAcc);
  float* cms = reinterpret_cast<float*>(sm + S::kMs);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sm + S::kBars);  // [warp]: its K box has landed
  uint64_t* v_full = k_full + W;                                   // [warp]: ... its V box

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(kFullMask, tid / 32, 0);
  if (tid == 0) {
    sm90::prefetch_map(&tm_k);
    sm90::prefetch_map(&tm_v);
    for (int w = 0; w < 2 * W; ++w) sm90::bar_init(k_full + w, 1);
    sm90::bar_fence_init();
  }
  const int rank = sm90::cluster_rank();
  const int unit = blockIdx.x / kCluster;    // (b, kv head, group)
  const int grp = unit % n_groups, hk = unit / n_groups % n_kv, b = unit / n_groups / n_kv;
  const int h0 = hk * rep + grp * R;
  const int nrows = min(R, rep - grp * R);
  const int len = kv_len[b];
  // the group's query rows, read now so that their latency and kv_len's
  // overlap; pad rows zero
  constexpr int QI = (R * HD / 4 + kThreads - 1) / kThreads;
  float4 qv[QI];
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int idx = tid + i * kThreads, r = idx / (HD / 4), col = (idx % (HD / 4)) * 4;
    qv[i] = idx < R * (HD / 4) && r < nrows ? load4(q + b * q_sb + int64_t(h0 + r) * HD + col)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n = min(max(len, 0), L);
  // this rank's span: ceil(n / kCluster) keys rounded up to the box
  const int span = ((n + kCluster - 1) / kCluster + kBox - 1) / kBox * kBox;
  const int k0 = min(rank * span, n), k1 = min(k0 + span, n);
  const int nb = (k1 - k0 + kBox - 1) / kBox;
  unsigned char* kt = sm + S::kK + warp * S::kBoxBytes;   // this warp's stage
  unsigned char* vt = sm + S::kV + warp * S::kBoxBytes;
  float* pw = reinterpret_cast<float*>(sm + S::kP) + warp * R * kBox;   // this warp's P
  // the K or V box i of the span into this warp's slot (one lane)
  auto load = [&](const CUtensorMap* map, unsigned char* slot, uint64_t* bar, int i) {
    sm90::bar_arrive_tx(bar, kBox * HD * int(sizeof(T)));
    sm90::tma_load_tile<HD, kBox, T>(slot, map, bar, hk, k0 + i * kBox, b);
  };

  __syncthreads();                             // the barriers are initialised
  if (lane == 0 && warp < nb) {
    load(&tm_k, kt, k_full + warp, warp);
    load(&tm_v, vt, v_full + warp, warp);
  }
  // q in f32, pre-scaled to log2 units
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int idx = tid + i * kThreads;
    const float4 x = qv[i];
    if (idx < R * (HD / 4))
      *reinterpret_cast<float4*>(qs + idx * 4) =
          make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2, x.w * scale_log2);
  }
  __syncthreads();

  float m[R], s[R], acc[R][NG][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[r][g][0] = acc[r][g][1] = acc[r][g][2] = acc[r][g][3] = 0.f;
  }
  for (int i = warp, it = 0; i < nb; i += W, ++it) {
    sm90::bar_wait(k_full + warp, it & 1);
    const int nk = min(kBox, k1 - (k0 + i * kBox));   // valid keys of the box, >= 1

    // scores: lane j <-> key j of the box, each head's dot product in four
    // independent chains (4-column groups round robin)
    float xc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) xc[r][0] = xc[r][1] = xc[r][2] = xc[r][3] = 0.f;
#pragma unroll
    for (int col = 0; col < HD; col += VEC) {
      float kf[VEC];
      widen16(reinterpret_cast<const T*>(kt + Lay::template offset<kBox>(lane, col)), kf);
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 kv = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
#pragma unroll
        for (int r = 0; r < R; ++r)
          xc[r][(col + e) / 4 % 4] +=
              dot4(*reinterpret_cast<const float4*>(qs + r * HD + col + e), kv);
      }
    }
    __syncwarp();                               // every lane is done with K
    if (lane == 0 && i + W < nb) {
      sm90::fence_proxy_async();
      load(&tm_k, kt, k_full + warp, i + W);
    }

    // the warp's online softmax: the box max, p = 2^(x - m), the rescale of
    // the earlier sums (the box's first key is valid, so m is finite)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = (xc[r][0] + xc[r][1]) + (xc[r][2] + xc[r][3]);
      const float xv = lane < nk ? x : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(xv));
      const float alpha = m[r] == -INFINITY ? 0.f : exp2f(m[r] - m_new);
      const float p = lane < nk ? exp2f(xv - m_new) : 0.f;
      s[r] = s[r] * alpha + p;
      m[r] = m_new;
      pw[r * kBox + lane] = p;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[r][g][0] *= alpha; acc[r][g][1] *= alpha;
        acc[r][g][2] *= alpha; acc[r][g][3] *= alpha;
      }
    }

    // the V rows of keys at and past kv_len zeroed, so that P.V runs over
    // the whole box (their p is 0, and 0 * NaN is NaN)
    sm90::bar_wait(v_full + warp, it & 1);
    for (int idx = lane; idx < (kBox - nk) * (HD / VEC); idx += 32)
      *reinterpret_cast<uint4*>(vt + Lay::template offset<kBox>(nk + idx / (HD / VEC),
                                                               idx % (HD / VEC) * VEC)) =
          make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();

    // P.V over the box's keys, four p's of each head at a time; the lane
    // owns dims 4*lane + 128*g
#pragma unroll
    for (int j0 = 0; j0 < kBox; j0 += 4) {
      float4 p4[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p4[r] = *reinterpret_cast<const float4*>(pw + r * kBox + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        float4 vv[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int d = 4 * lane + 128 * g;
          vv[g] = d < HD ? load4(reinterpret_cast<const T*>(vt + Lay::template offset<kBox>(j, d)))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[r][g][0] += pj * vv[g].x; acc[r][g][1] += pj * vv[g].y;
            acc[r][g][2] += pj * vv[g].z; acc[r][g][3] += pj * vv[g].w;
          }
        }
      }
    }
    __syncwarp();                               // every lane is done with V
    if (lane == 0 && i + W < nb) {
      sm90::fence_proxy_async();
      load(&tm_v, vt, v_full + warp, i + W);
    }
  }

  // the warps' states (where the stages were, once every warp is done with
  // its stage), then the CTA's: its warps merged in order
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float sr = warp_sum(s[r]);
    if (lane == 0) {
      wms[(warp * R + r) * 2] = m[r];
      wms[(warp * R + r) * 2 + 1] = sr;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * lane + 128 * g;
      if (d < HD)
        *reinterpret_cast<float4*>(wacc + (warp * R + r) * HD + d) =
            make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2], acc[r][g][3]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wms[(w * R + r) * 2]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = wms[(w * R + r) * 2];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      a += wacc[(w * R + r) * HD + d] * wt;
      sum += wms[(w * R + r) * 2 + 1] * wt;
    }
    cacc[idx] = a;
    if (d == 0) {
      cms[2 * r] = mx;
      cms[2 * r + 1] = sum;
    }
  }

  // every rank's state is written; rank `rank` merges its dims of each head
  sm90::cluster_sync();
  for (int idx = tid; idx < nrows * DPR; idx += kThreads) {
    const int r = idx / DPR, d = rank * DPR + idx % DPR;
    // every rank's (m, s, acc[d]) first, all in flight at once
    float mr[kCluster], sr[kCluster], ar[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      mr[c] = sm90::ld_cluster(cms + 2 * r, c);
      sr[c] = sm90::ld_cluster(cms + 2 * r + 1, c);
      ar[c] = sm90::ld_cluster(cacc + r * HD + d, c);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) mx = fmaxf(mx, mr[c]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      const float wt = mr[c] == -INFINITY ? 0.f : exp2f(mr[c] - mx);
      num += ar[c] * wt;
      den += sr[c] * wt;
    }
    store1(o + b * o_sb + int64_t(h0 + r) * HD + d, num / fmaxf(den, 1e-30f));
  }
  sm90::cluster_sync();                         // no CTA leaves while its state is read
}

template <typename T, int HD, int R>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                   int B, int Hq, int Hkv, int L, const long long* st, cudaStream_t stream) {
  using S = DecodeSmem<T, HD, R>;
  CUtensorMap tm_k, tm_v;
  cudaError_t err = sm90::make_map<HD, T>(&tm_k, k, B, L, Hkv, st[1], st[2], kBox);
  if (err == cudaSuccess) err = sm90::make_map<HD, T>(&tm_v, v, B, L, Hkv, st[3], st[4], kBox);
  if (err != cudaSuccess) return err;
  auto kern = decode_kernel<T, HD, R>;
  const size_t smem = S::kBytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rep = Hq / Hkv, n_groups = (rep + R - 1) / R;
  const float scale_log2 = rsqrtf(float(HD)) * 1.4426950408889634f;
  kern<<<kCluster * B * Hkv * n_groups, 32 * S::W, smem, stream>>>(
      tm_k, tm_v, static_cast<const T*>(q), kv_len, static_cast<T*>(o), Hq, rep, n_groups, Hkv,
      L, st[0], st[5], scale_log2);
  return cudaGetLastError();
}

// R: the least of 1, 2, 4, 8 that holds the GQA group (8 past that)
template <typename T, int HD>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                        int B, int Hq, int Hkv, int L, const long long* st, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  if (rep <= 1) return launch<T, HD, 1>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
  if (rep <= 2) return launch<T, HD, 2>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
  if (rep <= 4) return launch<T, HD, 4>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
  return launch<T, HD, 8>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     const int* kv_len, int B, int Hq, int Hkv, int L, const long long* st,
                     cudaStream_t stream) {
  switch (hd) {
#define CASE(HD) \
    case HD: return launch_rows<T, HD>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: q and o batch strides, k/v batch and sequence
// strides (head and feature dims dense).  kv_len is a device int32 (B,)
// vector.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention(const void* q, const void* k, const void* v, void* o,
                                const void* kv_len, int B, int Hq, int Hkv, int L, int hd,
                                int is_bf16, long long q_sb, long long k_sb, long long k_ss,
                                long long v_sb, long long v_ss, long long o_sb, void* stream) {
  const long long st[6] = {q_sb, k_sb, k_ss, v_sb, v_ss, o_sb};
  const int* lens = static_cast<const int*>(kv_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, lens, B, Hq, Hkv, L, st, s)
              : dispatch<float>(hd, q, k, v, o, lens, B, Hq, Hkv, L, st, s);
  return int(err);
}
