// Warp-level tensor-core building blocks of the bf16 dQ kernel (sm_80+ PTX,
// built for sm_90a): 16-byte cp.async tile copies with zero fill (also the
// decode kernel's), ldmatrix fragment loads, the m16n8k16 bf16 mma with f32
// accumulators, and the fragment index maps.  The forward and dK/dV kernels
// use Hopper's own instructions instead (sm90.cuh).
//
// Fragment layouts of mma.m16n8k16 (lane = 4*g + t, g = lane/4, t = lane%4):
//   A (16x16, row):  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B (16x8, col):   b0 (k 2t..2t+1, n g)               b1 (k 8+2t.., n g)
//   C (16x8, f32):   c0,c1 (g, 2t..2t+1)                c2,c3 (g+8, 2t..2t+1)
// Two adjacent C tiles (n 0-7 and 8-15) hold a 16x16 block in exactly the A
// layout, so a probability tile is reused as the A operand of the next
// product without leaving registers (pack_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Shared-memory rows are padded by 8 bf16 (16 bytes): with HD a multiple of
// 16, the 8 row addresses of each ldmatrix phase fall in 8 distinct 16-byte
// bank groups, so the fragment loads are free of bank conflicts.
constexpr int kPad = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of HD bf16 from global rows `row_stride` elements apart into a
// shared tile of pitch HD + kPad; rows at and past n_valid are zero-filled.
// Every thread of the block takes part.
template <int ROWS, int HD, int NTHREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int64_t row_stride, int n_valid, int tid) {
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
  static_assert(ROWS * kChunks % NTHREADS == 0, "tile copies divide evenly");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NTHREADS; ++it) {
    const int idx = tid + it * NTHREADS;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * (HD + kPad) + c, ok ? src + r * row_stride + c : src, ok);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i holds this lane's part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16x16, rounded to bf16) of two adjacent C tiles c0 | c1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Per-lane shared-memory offsets (row, column) for ldmatrix_x4 at the
// origin of a 16x16 block of a row-major tile:
//  * a_frag: the A operand of a row-major [m][k] tile;
//  * b_frag: the B operands of two n-tiles of a row-major [n][k] tile
//    (registers 0,1 -> n 0-7; 2,3 -> n 8-15);
//  * bt_frag (with ldmatrix_x4_trans): the B operands of two n-tiles of a
//    row-major [k][n] tile (registers 0,1 -> n 0-7; 2,3 -> n 8-15).
struct LaneOffsets {
  int a_row, a_col, b_row, b_col, bt_row, bt_col;
  __device__ explicit LaneOffsets(int lane)
      : a_row(lane & 15), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8),
        bt_row((lane & 7) + ((lane >> 3) & 1) * 8), bt_col((lane >> 4) * 8) {}
};

}  // namespace repro
