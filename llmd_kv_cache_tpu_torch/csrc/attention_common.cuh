// Device helpers shared by the paged-attention kernels in this directory
// (paged_attention.cu: GQA decode, prefill and ragged; latent_attention.cu:
// the single-KV-head wide-head decode and prefill of absorbed MLA and MQA).
//
// Which keys a query sees (the TPU kernels' _decode_stream_bounds,
// _decode_mask and the prefill tile bounds): key k of a sequence is
// attendable by a query at position p when k < total_len, k <= p, and, with
// a sliding window W, p - k < W or k < sinks. Pages wholly before the window
// are skipped; the first ceil(sinks / page_size) pages are streamed first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16-byte global->shared copy; when `pred` is false nothing is read and the
// destination is zero-filled (src-size operand 0).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The pages a program streams, as a list: sink pages [0, sink_pages) first,
// then window pages [first_window, ...). Virtual page j maps to page-table
// index page_index(j).
struct PageStream {
  int first_window;
  int sink_pages;
  int num_iters;  // pages in the list
  __device__ int page_index(int j) const {
    return j < sink_pages ? j : first_window + (j - sink_pages);
  }
};

__device__ __forceinline__ PageStream make_stream(int num_pages, int window_start,
                                                  int page_size, int sinks) {
  PageStream st;
  st.first_window = window_start < 0 ? 0 : window_start / page_size;
  if (st.first_window > num_pages) st.first_window = num_pages;
  st.sink_pages = 0;
  if (sinks > 0) {
    st.sink_pages = (sinks + page_size - 1) / page_size;
    if (st.sink_pages > num_pages) st.sink_pages = num_pages;
    if (st.first_window < st.sink_pages) st.first_window = st.sink_pages;
  }
  st.num_iters = st.sink_pages + num_pages - st.first_window;
  return st;
}

// Logical position of virtual key `vk` of the stream, or -1 when it lies
// past the list or at/after `limit` (the sequence's length).
__device__ __forceinline__ int key_position(const PageStream& st, int vk, int page_size,
                                            int pages_per_seq, int limit, int* page_idx) {
  int vp = vk / page_size;
  if (vp >= st.num_iters) return -1;
  int pidx = st.page_index(vp);
  if (pidx > pages_per_seq - 1) pidx = pages_per_seq - 1;
  int pos = pidx * page_size + (vk - vp * page_size);
  *page_idx = pidx;
  return pos < limit ? pos : -1;
}

// Position of key `key` of chunk `c` (of `ck` keys) of a decode stream
// whose chunk `tail_chunk` is the dense decode-burst tail: tail slot j sits
// at tail_base + j and holds a key while j < tail_keys. Other chunks are the
// stream's pages, as key_position.
__device__ __forceinline__ int decode_key_position(const PageStream& st, int c, int key, int ck,
                                                   int tail_chunk, int tail_keys, int tail_base,
                                                   int page_size, int pages_per_seq, int limit,
                                                   int* page_idx) {
  if (c == tail_chunk) return key < tail_keys ? tail_base + key : -1;
  return key_position(st, c * ck + key, page_size, pages_per_seq, limit, page_idx);
}

__device__ __forceinline__ bool attendable(int kpos, int qpos, int window, int sinks) {
  if (kpos < 0 || kpos > qpos) return false;
  if (window < 0) return true;
  return qpos - kpos < window || (sinks > 0 && kpos < sinks);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Which prefill tile of a ragged launch a CTA serves, found in the kernel
// from row_starts alone (no table built on the host or by other launches).
// Row r holds the flat slots [row_starts[r], row_starts[r + 1]), clamped to
// [0, total_q] as the kernels clamp them; a row of more than decode_tokens
// tokens owns ceil(len / tile_tokens) tiles, numbered on from the rows
// before it, a shorter row (the decode arm's, or an empty one) none. Tile
// slot s takes tile total - 1 - s, the last tiles first: a causal chunk's
// last tiles see the most keys, and slots past the last tile come last in
// the grid and exit. The calling warp reads the rows 32 at a time, counts
// their tiles and prefix-sums them by shuffles, then finds the first row
// whose tiles reach past the tile; every lane gets the same answer, so each
// warp of a CTA may run it alone, with no shared memory or barrier. All 32
// lanes must call it. row = -1 when the slot has no tile.
struct RaggedTile {
  int row;    // the row, or -1
  int start;  // its first flat slot (clamped)
  int len;    // its tokens (clamped)
  int t0;     // the tile's first token within the row
};

__device__ __forceinline__ int ragged_row_tiles(const int* __restrict__ row_starts, int r,
                                                int total_q, int tile_tokens, int decode_tokens,
                                                int* start, int* len) {
  *start = min(max(row_starts[r], 0), total_q);
  *len = min(max(row_starts[r + 1], *start), total_q) - *start;
  return *len > decode_tokens ? (*len + tile_tokens - 1) / tile_tokens : 0;
}

__device__ __forceinline__ RaggedTile ragged_tile(const int* __restrict__ row_starts, int rows,
                                                  int total_q, int tile_tokens,
                                                  int decode_tokens, int slot) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int total = 0, start = 0, len = 0;
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int tiles = r0 + lane < rows ? ragged_row_tiles(row_starts, r0 + lane, total_q,
                                                          tile_tokens, decode_tokens, &start, &len)
                                       : 0;
    total += __reduce_add_sync(kAll, tiles);
  }
  RaggedTile out = {-1, 0, 0, 0};
  const int t = total - 1 - slot;
  if (t < 0) return out;
  int base = 0;  // tiles of the rows before this group of 32
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int tiles = r0 + lane < rows ? ragged_row_tiles(row_starts, r0 + lane, total_q,
                                                          tile_tokens, decode_tokens, &start, &len)
                                       : 0;
    int incl = tiles;  // inclusive prefix sum over the group's lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(kAll, base + incl > t);
    if (hit != 0) {
      const int src = __ffs(hit) - 1;
      out.row = r0 + src;
      out.start = __shfl_sync(kAll, start, src);
      out.len = __shfl_sync(kAll, len, src);
      out.t0 = (t - base - __shfl_sync(kAll, incl - tiles, src)) * tile_tokens;
      return out;
    }
    base += __shfl_sync(kAll, incl, 31);
  }
  return out;
}

// Tile slots a ragged launch's prefill arm needs, from shapes only: a bound
// on the tiles ragged_tile can find. A row of len > decode_tokens tokens
// owns ceil(len / tile_tokens) <= (len + tile_tokens - 1) / tile_tokens
// tiles, and at most min(rows, total_q / (decode_tokens + 1)) rows are that
// long, so the tiles are at most (total_q + that many x (tile_tokens - 1))
// / tile_tokens. At least one slot, whose CTAs zero the slots past the last
// row when no row owns a tile.
__host__ __device__ inline int ragged_tile_slots(int total_q, int rows, int tile_tokens,
                                                 int decode_tokens) {
  const int cap = total_q / (decode_tokens + 1);
  const int long_rows = rows < cap ? rows : cap;
  const long long bound =
      (static_cast<long long>(total_q) + static_cast<long long>(long_rows) * (tile_tokens - 1)) /
      tile_tokens;
  return bound > 1 ? static_cast<int>(bound) : 1;
}

// Threads of a combine CTA at width D: one float4 of columns each.
template <int D>
constexpr int kCombineThreads = (D / 4 + 31) / 32 * 32;

// One row of a split-KV combine pass: the splits' unnormalised states
// merged as the online softmax would, out_row[d] = sum_s O_s[d] w_s with
// w_s = e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s.
// Split s keeps O_s at acc + s * acc_stride and m_s, l_s at ml[s *
// ml_stride] and ml[s * ml_stride + l_off]. A split that saw no key has m =
// -1e30, l = 0, O = 0 and adds nothing; a row no split saw gets zeros.
// Every thread of the CTA (kCombineThreads<D>) calls it and sums one float4
// of columns. Each warp reduces M and the sum of l over the splits itself
// (lane s takes split s, s + 32, ...) and passes split s's weight from lane
// s % 32 by shuffle, so no weight goes through shared memory and no barrier
// is needed. The first kAhead splits' columns are loaded before the
// weights are known: their L2 latency (the partials were just written)
// overlaps the reductions instead of following them.
template <int D>
__device__ __forceinline__ void merge_split_row(const float* __restrict__ acc, size_t acc_stride,
                                                const float* __restrict__ ml, int ml_stride,
                                                int l_off, int n_split,
                                                __nv_bfloat16* __restrict__ out_row, int tid) {
  static_assert(D % 4 == 0, "a combine thread takes a float4 of columns");
  constexpr int kAhead = 8;
  const int lane = tid & 31;
  const bool live = tid < D / 4;  // the others only join their warp's shuffles
  const float4* col = reinterpret_cast<const float4*>(acc) + (live ? tid : 0);
  const size_t step = acc_stride / 4;
  float4 ahead[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s)
    ahead[s] = s < n_split ? __ldg(col + s * step) : make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf;
  for (int s = lane; s < n_split; s += 32) m = fmaxf(m, __ldg(ml + s * ml_stride));
  m = warp_max(m);
  float l = 0.f;
  for (int s = lane; s < n_split; s += 32)
    l += __ldg(ml + s * ml_stride + l_off) * expf(__ldg(ml + s * ml_stride) - m);
  const float inv = 1.f / fmaxf(warp_sum(l), 1e-30f);
  auto weight = [&](int s) {  // 0 past the last split
    return s < n_split ? expf(__ldg(ml + s * ml_stride) - m) * inv : 0.f;
  };
  float w_lane = weight(lane);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float4& x, float w) {
    o.x += x.x * w;
    o.y += x.y * w;
    o.z += x.z * w;
    o.w += x.w * w;
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) add(ahead[s], __shfl_sync(0xffffffffu, w_lane, s));
#pragma unroll 8
  for (int s = kAhead; s < n_split; ++s) {
    if ((s & 31) == 0) w_lane = weight(s + lane);
    add(__ldg(col + s * step), __shfl_sync(0xffffffffu, w_lane, s & 31));
  }
  if (!live) return;
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out_row) + 2 * tid;
  orow[0] = __floats2bfloat162_rn(o.x, o.y);
  orow[1] = __floats2bfloat162_rn(o.z, o.w);
}

// mma.sync m16n8k16, bf16 operands, fp32 accumulate in place.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four e4m3 values (one 32-bit word, value i in byte i) as bf16 pairs (0, 1)
// and (2, 3), exactly: e4m3 -> f16 by the hardware's cvt (sm_89+; NaN stays
// NaN, subnormals exact), f16 -> f32 -> bf16 with no rounding (an e4m3
// value has 3 mantissa bits and an exponent bf16 holds).
__device__ __forceinline__ void e4m3x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  uint32_t h[2];
  asm("{\n.reg .b16 a, b;\nmov.b32 {a, b}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, a;\ncvt.rn.f16x2.e4m3x2 %1, b;\n}\n"
      : "=r"(h[0]), "=r"(h[1])
      : "r"(x));
  uint32_t out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2 v = *reinterpret_cast<const __half2*>(&h[i]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(__low2float(v), __high2float(v));
    out[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  lo = out[0];
  hi = out[1];
}

// 16 e4m3 values (16 bytes) as 16 bf16 values (two 16-byte halves), exactly.
__device__ __forceinline__ void e4m3x16_to_bf16(const uint4& in, uint4& lo, uint4& hi) {
  e4m3x4_to_bf16(in.x, lo.x, lo.y);
  e4m3x4_to_bf16(in.y, lo.z, lo.w);
  e4m3x4_to_bf16(in.z, hi.x, hi.y);
  e4m3x4_to_bf16(in.w, hi.z, hi.w);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragment of a k16 x n8 step when B is stored key-major ([k][n] with
// row stride ld, as V chunks are staged): two 16-bit reads per register.
// `p` points at B[2 * tig][gid] of the step.
template <int LD>
__device__ __forceinline__ void ld_b_kmajor(const __nv_bfloat16* p, uint32_t& b0, uint32_t& b1) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  b0 = static_cast<uint32_t>(u[0]) | (static_cast<uint32_t>(u[LD]) << 16);
  b1 = static_cast<uint32_t>(u[8 * LD]) | (static_cast<uint32_t>(u[9 * LD]) << 16);
}

// ldmatrix x4: four 8x8 b16 matrices from shared memory, lane l giving the
// 16-byte row l % 8 of matrix l / 8 at `p`; register i gets row lane / 4,
// columns 2 (lane % 4) and +1 of matrix i -- the mma.sync m16n8k16 B
// fragment register of an [n][k] (row = n) matrix. The transposed form
// gives column lane / 4, rows 2 (lane % 4) and +1: the same register of a
// [k][n] (row = k) matrix, as V chunks are staged.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

}  // namespace
