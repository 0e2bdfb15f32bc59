// Flash-decode attention of one query token over a KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (launched by decode_attention_kernel).  Same function: q (B, 1, Hq, hd)
// over k/v (B, L, Hkv, hd) valid to kv_len[b] (a device int32 (B,) vector;
// the wrapper broadcasts a scalar), GQA kv head = hq / rep, one online-softmax
// pass with f32 max, denominator and accumulator, denominator clamped at
// 1e-30, O in the input dtype.
//
// What bounds it on the H100: bytes.  Each cache entry up to kv_len is used
// for 2 FLOPs per query head of its group, far below the card's ridge point,
// so the least time is (K + V bytes up to kv_len) / 3.35 TB/s.  What the
// design does about it:
//  * one block per (b, kv head, group of up to 4 query heads): the rep query
//    heads that share a kv head are served from ONE read of its K/V, so the
//    cache is streamed once per kv head, not once per query head;
//  * K/V past kv_len[b] is never read (a tile's lanes past it load nothing);
//  * the block's 8 warps split the cache into 32-key tiles (warp w takes
//    tiles w, w+8, ...), each keeping its own running (max, sum, acc); the
//    partial states are merged through shared memory at the end;
//  * lane j scores key j with 4-element vector loads along its K row; for PV
//    each lane owns 4 consecutive output dims, so a V row is one coalesced
//    read by the warp, and 8 rows are in flight at once.
// Only B * Hkv blocks exist (32 at the serving shape), fewer than the 132
// SMs; splitting the sequence over more blocks (a second merge pass) is
// later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;      // query heads per block (one GQA group, or part)
constexpr int kTile = 32;     // keys per warp step (lane j <-> key j)
constexpr int kVB = 8;        // V rows loaded ahead of their use

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ kv_len, int rep, int L,
              int64_t q_sb, int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
              int64_t o_sb, float scale) {
  constexpr int NG = (HD + 127) / 128;    // 4-dim groups per lane: d = 4*lane + 128*g
  __shared__ __align__(16) float Qs[kRows][HD];
  __shared__ float Ms[kWarps][kRows], Ss[kWarps][kRows];
  __shared__ __align__(16) float As[kWarps][kRows][HD];

  const int hk = blockIdx.x, b = blockIdx.z;
  const int h0 = hk * rep + blockIdx.y * kRows;
  const int nrows = min(kRows, rep - int(blockIdx.y) * kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = min(max(kv_len[b], 0), L);

  for (int idx = tid; idx < kRows * (HD / 4); idx += kThreads) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) x = load4(q + b * q_sb + int64_t(h0 + r) * HD + c);
    *reinterpret_cast<float4*>(&Qs[r][c]) = x;
  }
  __syncthreads();

  const T* kb = k + b * k_sb + int64_t(hk) * HD;
  const T* vb = v + b * v_sb + int64_t(hk) * HD;
  float m[kRows], s[kRows], acc[kRows][NG][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      acc[r][g][0] = acc[r][g][1] = acc[r][g][2] = acc[r][g][3] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < n; t0 += kWarps * kTile) {
    const int key = t0 + lane;
    const bool ok = key < n;
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    if (ok) {
      const T* krow = kb + key * k_ss;
#pragma unroll 8
      for (int c = 0; c < HD; c += 4) {
        const float4 kk = load4(krow + c);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          sc[r] += dot4(*reinterpret_cast<const float4*>(&Qs[r][c]), kk);
      }
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = ok && r < nrows ? sc[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      p[r] = x == -INFINITY ? 0.f : expf(x - m_new);
      const float alpha = rescale(m[r], m_new);
      s[r] = s[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[r][g][0] *= alpha; acc[r][g][1] *= alpha;
        acc[r][g][2] *= alpha; acc[r][g][3] *= alpha;
      }
    }
    // PV in batches of kVB rows: the batch's V loads are all issued before
    // any is consumed, so their latencies overlap instead of adding up
    const int n_keys = min(kTile, n - t0);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kVB) {
      if (j0 >= n_keys) break;
      float4 vv[kVB][NG];
#pragma unroll
      for (int jj = 0; jj < kVB; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int d = 4 * lane + 128 * g;
          vv[jj][g] = j0 + jj < n_keys && d < HD ? load4(vb + (t0 + j0 + jj) * v_ss + d)
                                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kVB; ++jj) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFullMask, p[r], j0 + jj);   // all lanes
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[r][g][0] += pj * vv[jj][g].x; acc[r][g][1] += pj * vv[jj][g].y;
            acc[r][g][2] += pj * vv[jj][g].z; acc[r][g][3] += pj * vv[jj][g].w;
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) { Ms[warp][r] = m[r]; Ss[warp][r] = s[r]; }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * lane + 128 * g;
      if (d < HD)
        *reinterpret_cast<float4*>(&As[warp][r][d]) =
            make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2], acc[r][g][3]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Ms[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(Ms[w][r], mx);
      den += Ss[w][r] * f;
      num += As[w][r][d] * f;
    }
    store1(o + b * o_sb + int64_t(h0 + r) * HD + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                   int B, int Hq, int Hkv, int L, const long long* st, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const dim3 grid(Hkv, (rep + kRows - 1) / kRows, B);
  decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, rep, L, st[0], st[1], st[2], st[3], st[4], st[5],
      rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     const int* kv_len, int B, int Hq, int Hkv, int L, const long long* st,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    case 96: return launch<T, 96>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
    case 160: return launch<T, 160>(q, k, v, o, kv_len, B, Hq, Hkv, L, st, stream);
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
                                long long v_sb, long long v_ss, long long o_sb,
                                void* stream) {
  const long long st[6] = {q_sb, k_sb, k_ss, v_sb, v_ss, o_sb};
  const int* lens = static_cast<const int*>(kv_len);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, lens, B, Hq, Hkv, L, st, s)
              : dispatch<float>(hd, q, k, v, o, lens, B, Hq, Hkv, L, st, s);
  return int(err);
}
