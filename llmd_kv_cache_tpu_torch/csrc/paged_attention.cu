// Paged attention for NVIDIA Hopper (sm_90a): flash decode, flash prefill
// and ragged mixed prefill + decode over a paged KV pool laid out [pages,
// kv_heads, page_size, head_dim] (one layer's view of the engine's [layers,
// ...] stack), of bf16 or of fp8 e4m3 (the F8 instantiations; q and out are
// bf16 either way).
//
// Built by llmd_kv_cache_tpu_torch/ops/cuda_build.py into a plain-C shared
// library loaded with ctypes; llmd_kv_cache_tpu_torch/ops/cuda_paged_attention.py
// checks shapes, types and devices and calls the entry points at the end of
// this file. Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 = launched), or -1 for a shape it was not built for.
//
// Numerics (all kernels) follow the TPU kernels they replace: QK^T on bf16
// operands with fp32 accumulation, the softmax scale applied to the fp32
// scores, masked scores at -1e30, an fp32 online softmax, p rounded to bf16
// before the PV product (fp32 accumulation), and out = acc / max(l, 1e-30).
// A masked key contributes p = 0 exactly; a row with no attendable key (a
// padded decode row, total_len == 0) therefore returns zeros, never NaN.
// Keys past a sequence's length are zero-filled in shared memory, so stale
// or uninitialized pages never reach the products.
//
// fp8 (e4m3) pools (the quantized arms of _decode_kernel_merged and
// _ragged_kernel, pallas_paged_attention.py:402-530 and :767-892): a staged
// chunk moves its keys' 1-byte rows, half the bytes (a 128-wide row is 8
// sixteen-byte cp.async copies, not 16), and is converted to bf16 in shared
// memory (e4m3x16_to_bf16, exact) into the rows the bf16 arm's ldmatrix and
// wgmma reads take. From there the math is the bf16 arm's: Q is not
// quantized and no fp8 product runs, so the result is the reference's
// upcast-then-attend. A decode-burst tail of an fp8 pool is fp8 too and is
// staged like a page. The JAX package prefills an fp8 pool with XLA
// attention over the upcast pages (engine.py:855-866); the GQA prefill
// kernel's fp8 arm computes that same function.
//
// Two tiles carry every kernel here: split_decode_tile (a few query tokens
// of one row over one split of its keys; the decode kernel and the ragged
// kernel's decode arm) and ragged_prefill_tile (128 query rows on wgmma; the
// prefill kernel and the ragged kernel's prefill arm). The key-visibility
// rules and the device helpers are in attention_common.cuh and
// hopper_common.cuh.

#include "hopper_common.cuh"

namespace {

constexpr int kChunk = 64;          // keys a staged chunk, and the most burst-tail slots
constexpr int kDecodeRows = 16;     // a decode tile: tokens x G heads, one m16 tile
constexpr int kDecodeThreads = 128; // a decode tile's 4 warps
constexpr int kRaggedThreads = 256;      // two warpgroups
constexpr int kRaggedPrefillRows = 128;  // a prefill tile: one 64-row wgmma tile a warpgroup
constexpr int kSmemPerSm = 233472;       // an H100 SM's 228 KB of shared memory

// A pool's element: bf16, or an fp8 e4m3 byte (F8).
template <bool F8>
struct KvElem {
  using T = __nv_bfloat16;
};
template <>
struct KvElem<true> {
  using T = uint8_t;
};
template <bool F8>
using KvT = typename KvElem<F8>::T;

// Shared memory of split_decode_tile: K and V of kStages staged 64-key
// chunks, bf16 in padded rows (the rows ldmatrix reads) or, for an fp8
// pool, 1-byte rows followed by one chunk of K and V in padded bf16 rows,
// which each warp fills with its own 16 keys converted (then the 4 warps'
// merge scratch); after them the chunks' key metadata: positions
// [kPosSlots][64] i32, then K/V row offsets [kPosSlots][64] i64. 105 KB at
// head_dim 128 (85 KB for fp8), so two decode CTAs share an SM.
template <int D, bool F8 = false>
struct DecodeSmem {
  static constexpr int kStages = 3;    // chunks in flight: 2 loading, 1 in use
  static constexpr int kPosSlots = 4;  // metadata of the stages' chunks and the next one
  static constexpr int LD = D + 8;     // padded row: conflict-free ldmatrix rows
  static constexpr int kRow = F8 ? D : LD * 2;  // bytes of a staged row
  static constexpr int kStaged = kStages * 2 * kChunk * kRow;
  static constexpr int kConv = F8 ? 2 * kChunk * LD * 2 : 0;  // the converted chunk
  static constexpr int kKpos = kStaged + kConv;
  static constexpr int kMeta = kPosSlots * kChunk * (4 + 8);
  static constexpr int kBytes = kKpos + kMeta;
  static_assert(4 * kDecodeRows * (D + 2) * 4 <= kKpos, "merge scratch");
};
// The wrappers plan the split decode for two CTAs an SM (DECODE_CTAS_PER_SM
// in ops/cuda_paged_attention.py), bf16 or fp8.
static_assert(2 * (DecodeSmem<128, false>::kBytes + 1024) <= kSmemPerSm &&
                  2 * (DecodeSmem<128, true>::kBytes + 1024) <= kSmemPerSm,
              "two decode CTAs an SM");

// Shared memory of the ragged kernel and of the prefill kernel, the larger
// of the arms' needs: the prefill tile's K and V chunks in kSwStages
// swizzled bf16 buffers (for an fp8 pool followed by the kStages 1-byte
// stages that cp.async fills and the tile converts from), or the decode
// tile's stages; after them the staged chunks' key positions,
// [kStages][64], or the decode tile's key metadata.
template <int D, bool F8 = false>
struct RaggedSmem {
  // Chunks in flight: bf16, 4 swizzled stages (2 loading, 1 scored, 1 in
  // P V); fp8, 3 byte stages (2 loading, 1 converted) and 2 swizzled ones
  // (1 scored, 1 in P V), since the conversion fills a swizzled stage at
  // once.
  static constexpr int kStages = F8 ? 3 : 4;
  static constexpr int kSwStages = F8 ? 2 : kStages;
  static constexpr int kBlk = 64 * 128;  // 64 rows x 64 bf16 columns, swizzled
  static constexpr int NB = D / 64;
  static constexpr int kSwizzled = 2 * kSwStages * NB * kBlk;
  static constexpr int kPrefill = kSwizzled + (F8 ? 2 * kStages * kChunk * D : 0);
  static constexpr int kDecode = DecodeSmem<D, F8>::kKpos;
  static constexpr int kKpos = kPrefill > kDecode ? kPrefill : kDecode;
  static constexpr int kMeta = kStages * kChunk * 4 > DecodeSmem<D, F8>::kMeta
                                   ? kStages * kChunk * 4
                                   : DecodeSmem<D, F8>::kMeta;
  static constexpr int kBytes = 1024 + kKpos + kMeta;
};

// ---------------------------------------------------------------------------
// Split decode. Replaces _decode_kernel_merged and its burst-tail fold
// _tail_fold (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:375, :186), and
// serves the decode rows of _ragged_kernel (:736).
//
// A decode row's n_tok (<= 16 / G) query tokens x the G heads of kv head h
// are one m16 tile. Bound on the H100: bytes. Each key's K and V are read
// once: at batch 8 over 4160-token contexts with 8 kv heads of 128 that is
// 136 MB a layer, 0.041 ms at 3.35 TB/s, against ~0.14 GFLOP of products.
// One CTA a (row, kv head) is 64 CTAs on 132 SMs, each streaming 65 chunks,
// so each (row, kv head)'s keys are split across n_split CTAs
// (flash-decoding): CTA `split` takes the split-th of n_split equal runs of
// the row's 64-key chunks. In each CTA 4 warps take 16 keys each of every
// staged chunk and keep their own online softmax state: S = Q K^T and O +=
// P V on mma.sync m16n8k16, B fragments by ldmatrix (V transposed on the
// way), p fed back from the score accumulators as the A fragment. Chunks
// stream through three cp.async stages, two loading while one is computed.
// Each key's position and K/V row offset are staged in shared memory one
// chunk ahead of its copies (by 64 threads, one key each), so that the
// copies are coalesced: consecutive threads take consecutive 16-byte pieces
// of a row, a warp whole 256-byte rows; the position also serves the mask.
// At the end the
// 4 warps' states merge in shared memory. With n_split == 1 the CTA writes
// the output; else its state, O before the 1 / l, m and l, to part_acc
// ([16][D] fp32) and part_ml ([2][16]), and split_combine_kernel merges the
// splits (merge_split_row). A split that sees no key writes m = -1e30, l =
// 0, O = 0. The split count comes from shapes only (the wrappers' planners),
// so planning reads no length on the device and a captured CUDA graph
// replays any lengths.
//
// Token i sits at position q_pos + i; the paged keys are [0, total) of the
// pages in `table`, from the window start of token 0 (q_pos - window + 1),
// plus the sink pages. The decode-burst tail (TAIL; _tail_fold): tail_keys
// > 0 only on a row's last split, which folds the dense tail as one more
// staged chunk after its paged ones, slot j (at tail_k + j * kv_heads * D)
// at position total + j; its other slots are zero-filled and masked. The
// caller sits the query at ctx + tail_len - 1 (q_pos) past the paged keys
// (total = ctx). The tail's p is rounded to bf16 for PV like every chunk's
// (the TPU fold keeps it fp32). The tail code exists only in the TAIL
// instantiation, so the paged loop of the other carries none of it.
//
// fp8 (F8): the stages hold 1-byte rows; after the barrier that publishes
// chunk c each warp converts its own 16 keys' K and V rows into one padded
// bf16 chunk, which only that warp reads, so no other barrier is needed.
//
// Run by 128 threads (4 warps) synchronised by barrier 1: the decode
// kernel's CTA, or the first warpgroup of a ragged CTA (the other has left).
// ---------------------------------------------------------------------------

template <int D, int G, bool TAIL, bool F8>
__device__ __forceinline__ void split_decode_tile(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const KvT<F8>* __restrict__ k, const KvT<F8>* __restrict__ v,
    const int* __restrict__ table, int n_tok, int q_pos, int total, int h, int kv_heads,
    int page_size, int pages_per_seq, int window, int sinks, float scale, unsigned char* smem,
    unsigned char* meta, int split, int n_split, float* __restrict__ part_acc,
    float* __restrict__ part_ml, const KvT<F8>* __restrict__ tail_k = nullptr,
    const KvT<F8>* __restrict__ tail_v = nullptr, int tail_keys = 0) {
  using S = DecodeSmem<D, F8>;
  constexpr int CK = kChunk, R = kDecodeRows;
  constexpr int LD = S::LD, ST = S::kStages, ROW = S::kRow;
  constexpr int PS = S::kPosSlots;
  constexpr int EPP = 16 / sizeof(KvT<F8>);  // elements a 16-byte copy
  constexpr int PIECES = D / EPP, KS = D / 16, NO = D / 8;
  constexpr int RPP = kDecodeThreads / PIECES;  // key rows a copy pass covers
  static_assert(CK == 64 && CK <= kDecodeThreads, "4 warps x 16 keys a chunk");
  static_assert(KS % 2 == 0, "ldmatrix takes two k-steps of K at a time");
  static_assert(PS == ST + 1 && CK % RPP == 0, "metadata one chunk ahead");
  unsigned char* ks = smem;                     // [ST][CK][ROW]
  unsigned char* vs = smem + ST * CK * ROW;     // [ST][CK][ROW]
  // fp8: the converted chunk, [CK][LD] bf16 each of K and V.
  __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(smem + S::kStaged);
  __nv_bfloat16* vc = kc + CK * LD;
  int* kpos_s = reinterpret_cast<int*>(meta);                  // [PS][CK]
  long long* roff_s = reinterpret_cast<long long*>(meta + PS * CK * 4);  // [PS][CK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_heads = kv_heads * G;
  const int live_rows = n_tok * G;

  // This lane's two rows (mma fragment rows gid and gid + 8).
  int qpos[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r, tok = row / G;
    qpos[r] = q_pos + tok;
    qrow[r] = tok < n_tok ? q + (static_cast<size_t>(tok) * q_heads + h * G + row % G) * D
                          : nullptr;
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int k0 = s * 16 + 2 * tig;
    qa[s][0] = qrow[0] ? ld32(qrow[0] + k0) : 0u;
    qa[s][1] = qrow[1] ? ld32(qrow[1] + k0) : 0u;
    qa[s][2] = qrow[0] ? ld32(qrow[0] + k0 + 8) : 0u;
    qa[s][3] = qrow[1] ? ld32(qrow[1] + k0 + 8) : 0u;
  }

  const int num_pages = (total + page_size - 1) / page_size;
  const PageStream st =
      make_stream(num_pages, window >= 0 ? q_pos - window + 1 : 0, page_size, sinks);
  const int n_chunks = (st.num_iters * page_size + CK - 1) / CK;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const int c_begin = min(split * per_split, n_chunks);
  const int c_end = min(c_begin + per_split, n_chunks);
  // Chunk c_end, when this split folds a tail, is the tail.
  const int c_stop = c_end + (TAIL && tail_keys > 0 ? 1 : 0);

  // Key metadata of chunk c (64 threads, one key each) into slot (c -
  // c_begin) % PS: its position (-1: none) and the element offset of its K
  // and V rows (-1: zero-filled), in the pool or, for the tail chunk, in the
  // dense tail.
  auto stage_meta = [&](int c) {
    if (tid < CK && c < c_stop) {
      const int slot = (c - c_begin) % PS;
      int pos;
      long long off;
      if (TAIL && c == c_end) {
        pos = tid < tail_keys ? total + tid : -1;
        off = pos >= 0 ? (static_cast<long long>(tid) * kv_heads + h) * D : -1;
      } else {
        int pidx = 0;
        pos = key_position(st, c * CK + tid, page_size, pages_per_seq, total, &pidx);
        off = pos >= 0 ? ((static_cast<long long>(table[pidx]) * kv_heads + h) * page_size +
                          pos % page_size) * D
                       : -1;
      }
      kpos_s[slot * CK + tid] = pos;
      roff_s[slot * CK + tid] = off;
    }
  };
  // Chunk c's K and V into stage (c - c_begin) % ST from its staged
  // metadata: thread t copies piece t % PIECES of rows t / PIECES + RPP i.
  // Past the split's last chunk a stage commits an empty group, so that
  // every iteration waits for the same count.
  auto load_chunk = [&](int c) {
    if (c < c_stop) {
      const int buf = (c - c_begin) % ST, slot = (c - c_begin) % PS;
      const bool tail = TAIL && c == c_end;
      const KvT<F8>* ksrc = tail ? tail_k : k;
      const KvT<F8>* vsrc = tail ? tail_v : v;
      const int piece = tid % PIECES;
#pragma unroll
      for (int i = 0; i < CK / RPP; ++i) {
        const int key = tid / PIECES + RPP * i;
        const long long off = roff_s[slot * CK + key];
        const size_t src = static_cast<size_t>(off >= 0 ? off : 0) + piece * EPP;
        const int dst = (buf * CK + key) * ROW + piece * 16;
        cp_async_16(ks + dst, ksrc + src, off >= 0);
        cp_async_16(vs + dst, vsrc + src, off >= 0);
      }
    }
    cp_async_commit();
  };

  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int key0 = warp * 16;
  // ldmatrix row addresses: lane l gives row l % 8 of 8x8 matrix l / 8.
  // K (not transposed): matrix i is keys [key0 + 8 n, +8) x dims [8 i, +8)
  // of a k-step pair, so registers 0-3 are b0, b1 of k-step 2s and of 2s + 1.
  // V (transposed): matrix i is keys [key0 + 8 (i & 1), +8) x dims [16 j +
  // 8 (i >> 1), +8), so registers 0-3 are b0, b1 of n-tiles 2j and 2j + 1.
  const int k_ld = (key0 + (lane & 7)) * LD + (lane >> 3) * 8;
  const int v_ld = (key0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);

#pragma unroll
  for (int i = 0; i < ST; ++i) stage_meta(c_begin + i);
  named_barrier(1, kDecodeThreads);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load_chunk(c_begin + i);
  for (int c = c_begin; c < c_stop; ++c) {
    const int buf = (c - c_begin) % ST, slot = (c - c_begin) % PS;
    cp_async_wait<ST - 2>();
    // Chunk c landed; chunk c - 1's stage and metadata slot are free; chunk
    // c + ST - 1's metadata is published.
    named_barrier(1, kDecodeThreads);
    load_chunk(c + ST - 1);
    stage_meta(c + ST);
    const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ks + buf * CK * ROW);
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vs + buf * CK * ROW);
    if constexpr (F8) {
      // This warp's keys [key0, key0 + 16) of K and V, 1-byte rows to bf16
      // rows: lane l takes 16-byte piece l % (D / 16) of a row, a warp whole
      // rows (conflict-free reads).
      constexpr int P8 = D / 16;
      __syncwarp();  // the warp's reads of the previous chunk are done
#pragma unroll
      for (int i = 0; i < 16 * P8 / 32; ++i) {
        const int j = lane + 32 * i, row = key0 + j / P8, p = j % P8;
        uint4 lo, hi;
        e4m3x16_to_bf16(*reinterpret_cast<const uint4*>(ks + (buf * CK + row) * D + p * 16),
                        lo, hi);
        reinterpret_cast<uint4*>(kc + row * LD + p * 16)[0] = lo;
        reinterpret_cast<uint4*>(kc + row * LD + p * 16)[1] = hi;
        e4m3x16_to_bf16(*reinterpret_cast<const uint4*>(vs + (buf * CK + row) * D + p * 16),
                        lo, hi);
        reinterpret_cast<uint4*>(vc + row * LD + p * 16)[0] = lo;
        reinterpret_cast<uint4*>(vc + row * LD + p * 16)[1] = hi;
      }
      __syncwarp();
      kb = kc;
      vb = vc;
    }

    // S = Q K^T: this warp's 16 keys as two n8 tiles.
    float s_acc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; s += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + k_ld + n * 8 * LD + s * 16);
        mma_16816(s_acc[n], qa[s], b[0], b[1]);
        mma_16816(s_acc[n], qa[s + 1], b[2], b[3]);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kpos_s[slot * CK + key0 + n * 8 + 2 * tig + j];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s_acc[n][2 * r + j];
          x = attendable(kpos, qpos[r], window, sinks) ? x * scale : kNegInf;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s_acc[n][2 * r + j];
          x = x > 0.5f * kNegInf ? expf(x - m_new) : 0.f;
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
    // O = alpha O + P V: the score accumulators of the two key tiles are
    // the A fragment of the k16 step (p rounded to bf16 here).
    uint32_t pa[4];
    pa[0] = pack_bf16(s_acc[0][0], s_acc[0][1]);
    pa[1] = pack_bf16(s_acc[0][2], s_acc[0][3]);
    pa[2] = pack_bf16(s_acc[1][0], s_acc[1][1]);
    pa[3] = pack_bf16(s_acc[1][2], s_acc[1][3]);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + v_ld + n * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o_acc[n + i][0] *= alpha[0];
        o_acc[n + i][1] *= alpha[0];
        o_acc[n + i][2] *= alpha[1];
        o_acc[n + i][3] *= alpha[1];
        mma_16816(o_acc[n + i], pa, b[2 * i], b[2 * i + 1]);
      }
    }
  }
  cp_async_wait<0>();
  named_barrier(1, kDecodeThreads);  // every warp is done with the staged chunks

  // Merge the 4 warps' states of the live rows: scratch [4][16][D] O, then
  // [4][16] m and l.
  float* ow = reinterpret_cast<float*>(smem);
  float* mw = ow + 4 * R * D;
  float* lw = mw + 4 * R;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r;
    if (row >= live_rows) continue;
    float* orow = ow + (warp * R + row) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(o_acc[n][2 * r], o_acc[n][2 * r + 1]);
    if (tig == 0) {
      mw[warp * R + row] = m_run[r];
      lw[warp * R + row] = l_run[r];
    }
  }
  named_barrier(1, kDecodeThreads);
  for (int i = tid; i < live_rows * D; i += kDecodeThreads) {
    const int row = i / D, d = i - row * D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, mw[w * R + row]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = expf(mw[w * R + row] - m);
      l += lw[w * R + row] * f;
      o += ow[(w * R + row) * D + d] * f;
    }
    if (part_acc != nullptr) {
      part_acc[row * D + d] = o;
      if (d == 0) {
        part_ml[row] = m;
        part_ml[R + row] = l;
      }
    } else {
      out[(static_cast<size_t>(row / G) * q_heads + h * G + row % G) * D + d] =
          __float2bfloat16_rn(o / fmaxf(l, 1e-30f));
    }
  }
}

// The decode kernel: one query token a row at position ctx_lens[b] - 1 (or
// ctx + tail_len - 1 past a burst tail) over the row's paged keys. Grid
// (batch x kv_heads, n_split); with n_split > 1 each CTA writes its state
// to part_acc [B, Hkv, n_split, 16, D] and part_ml [B, Hkv, n_split, 2, 16]
// for split_combine_kernel.
template <int D, int G, bool TAIL, bool F8>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
                  const KvT<F8>* __restrict__ k,        // [P, Hkv, ps, D]
                  const KvT<F8>* __restrict__ v,
                  const int* __restrict__ page_table,  // [B, pps]
                  const int* __restrict__ ctx_lens,    // [B] paged keys to attend
                  const KvT<F8>* __restrict__ tail_k,  // [B, T, Hkv, D] or null
                  const KvT<F8>* __restrict__ tail_v,
                  const int* __restrict__ tail_lens,  // [B] valid tail slots
                  __nv_bfloat16* __restrict__ out,    // [B, Hq, D]
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int kv_heads,
                  int page_size, int pages_per_seq, int tail_slots, int window, int sinks,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / kv_heads, h = blockIdx.x - b * kv_heads;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int ctx = ctx_lens[b];
  const int tail_len = TAIL ? max(tail_lens[b], 0) : 0;
  const bool fold = TAIL && tail_len > 0 && split == n_split - 1;
  const size_t row = static_cast<size_t>(b) * kv_heads * G * D;
  const size_t tail_row = static_cast<size_t>(b) * tail_slots * kv_heads * D;
  const size_t part = (static_cast<size_t>(b) * kv_heads + h) * n_split + split;
  split_decode_tile<D, G, TAIL, F8>(
      q + row, out + row, k, v, page_table + static_cast<size_t>(b) * pages_per_seq, 1,
      ctx + tail_len - 1, ctx, h, kv_heads, page_size, pages_per_seq, window, sinks, scale, smem,
      smem + DecodeSmem<D, F8>::kKpos, split, n_split,
      n_split > 1 ? part_acc + part * kDecodeRows * D : nullptr,
      n_split > 1 ? part_ml + part * 2 * kDecodeRows : nullptr,
      fold ? tail_k + tail_row : nullptr, fold ? tail_v + tail_row : nullptr,
      fold ? min(tail_len, tail_slots) : 0);
}

// ---------------------------------------------------------------------------
// Prefill tile. New queries at positions ctx + i attend causally over the
// cached prefix and themselves (their KV already scattered). Bound on the
// H100: operations; a 2048-token chunk over a 2048-token prefix is ~51 GFLOP
// of QK^T + PV a layer, 0.052 ms at 989 TFLOP/s, against ~34 MB of traffic.
// A tile is 128 query rows, 128 / G tokens x the G query heads of one kv
// head, so every key staged in shared memory serves the whole group. Two
// warpgroups a tile, 64 rows (one wgmma M tile) each, share every 64-key
// chunk of K and V, staged swizzled by cp.async in four stages. Q stays in
// registers: S = Q K^T is m64n64k16 with A from registers, the softmax runs
// on the accumulators (log2 units; the mask is skipped where every key is
// visible), and p, rounded to bf16, is the register A operand of P V
// (m64nDk16, V read MN-major). The loop is software-pipelined as
// FlashAttention-3's: the tensor cores run chunk c's scores and then chunk
// c - 1's P V while the softmax of chunk c runs. fp8 (F8): cp.async fills
// three 1-byte stages; after the barrier that publishes chunk c all 256
// threads convert it into one of two swizzled bf16 stages (the layout and
// 1024-byte alignment the wgmma descriptors read), fence it to the async
// proxy and meet at a second barrier, and the products run as for bf16.
// ---------------------------------------------------------------------------

// One prefill tile of 128 rows: tokens [t0, t0 + QT) of a row's n_tok new
// tokens, laid out [token, q_heads, D] from `q` (and `out`), token i at
// position ctx + i, over keys [0, total) of the pages in `table`, for kv
// head h. Row r of the tile is head h * G + r % G of token t0 + r / G;
// warpgroup w takes rows [64 w, 64 w + 64) as one wgmma M tile, and both
// share every staged chunk (twice the rows a CTA, half the L2 traffic of a
// 64-row tile). The queries stay in registers as the A operand of S = Q
// K^T (the mma.sync A fragment is wgmma's register A layout), so shared
// memory holds only K and V: four stages of both, one scored, one in P V,
// two loading. Tokens at and past n_tok are neither computed nor written;
// a token whose position lies at or past `total` (a padded token of a
// prefill chunk) attends the keys below `total`.
template <int D, int G, bool F8>
__device__ __forceinline__ void ragged_prefill_tile(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const KvT<F8>* __restrict__ k, const KvT<F8>* __restrict__ v,
    const int* __restrict__ table, int n_tok, int t0, int ctx, int total, int h, int kv_heads,
    int page_size, int pages_per_seq, int window, int sinks, float scale, unsigned char* smem) {
  constexpr int CK = kChunk, QT = kRaggedPrefillRows / G, PIECES = D / 8, KS = D / 16;
  using S = RaggedSmem<D, F8>;
  constexpr int NB = S::NB, kBlk = S::kBlk, ST = S::kStages, SW = S::kSwStages;
  // Chunks loading ahead: a bf16 stage holds V until its P V is done; an
  // fp8 stage is free once converted.
  constexpr int LA = F8 ? ST - 1 : ST - 2;
  static_assert(kRaggedPrefillRows == 64 * (kRaggedThreads / 128) && CK == 64, "wgmma tiles");
  unsigned char* ks = smem;                 // [SW][NB][64 keys]
  unsigned char* vs = ks + SW * NB * kBlk;  // [SW][NB][64 keys]
  unsigned char* k8 = smem + S::kSwizzled;  // fp8: [ST][CK][D] bytes
  unsigned char* v8 = k8 + ST * CK * D;
  int* kpos_s = reinterpret_cast<int*>(smem + S::kKpos);  // [ST][CK]
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_heads = kv_heads * G;

  // This lane's two rows (fragment rows gid and gid + 8 of its warp's 16)
  // and their queries as A fragments, zeros past n_tok.
  int qpos[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + gid + 8 * r, tok = t0 + row / G;
    qpos[r] = ctx + tok;
    qrow[r] = tok < n_tok ? q + (static_cast<size_t>(tok) * q_heads + h * G + row % G) * D
                          : nullptr;
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k0 = kk * 16 + 2 * tig;
    qa[kk][0] = qrow[0] ? ld32(qrow[0] + k0) : 0u;
    qa[kk][1] = qrow[1] ? ld32(qrow[1] + k0) : 0u;
    qa[kk][2] = qrow[0] ? ld32(qrow[0] + k0 + 8) : 0u;
    qa[kk][3] = qrow[1] ? ld32(qrow[1] + k0 + 8) : 0u;
  }

  // Keys this tile can see: up to its last query (causal), from the window
  // start of its first query, plus the sink pages.
  const int q_start = ctx + t0;
  int max_key = q_start + QT < total ? q_start + QT : total;
  if (max_key < 0) max_key = 0;
  const int num_pages = (max_key + page_size - 1) / page_size;
  const PageStream st =
      make_stream(num_pages, window >= 0 ? q_start - window + 1 : 0, page_size, sinks);
  const int n_chunks = (st.num_iters * page_size + CK - 1) / CK;

  // Four threads a key: each computes its position once and copies every
  // fourth 16-byte piece of its K and V rows; the first records the
  // position for the mask. Past the last chunk a stage commits an empty
  // group, so that every iteration waits for the same count.
  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      const int buf = c % ST;
      const int key = tid >> 2, sub = tid & 3;
      int pidx = 0;
      const int pos = key_position(st, c * CK + key, page_size, pages_per_seq, total, &pidx);
      const bool ok = pos >= 0;
      const size_t row =
          ok ? ((static_cast<size_t>(table[pidx]) * kv_heads + h) * page_size +
                pos % page_size) * D
             : 0;
      if (sub == 0) kpos_s[buf * CK + key] = pos;
      if constexpr (F8) {
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {  // the row's D / 16 pieces, 4 threads
          const int p = sub + 4 * j;
          const int dst = (buf * CK + key) * D + p * 16;
          cp_async_16(k8 + dst, k + row + p * 16, ok);
          cp_async_16(v8 + dst, v + row + p * 16, ok);
        }
      } else {
#pragma unroll
        for (int j = 0; j < PIECES / 4; ++j) {
          const int p = sub + 4 * j;
          const int dst = (buf * NB + (p >> 3)) * kBlk + sw128(key, p & 7);
          cp_async_16(ks + dst, k + row + p * 8, ok);
          cp_async_16(vs + dst, v + row + p * 8, ok);
        }
      }
    }
    cp_async_commit();
  };
  // fp8: chunk c's 1-byte K and V rows into swizzled bf16 stage c % SW.
  // Piece j (16 values) of a row is bf16 pieces 2j and 2j + 1, in 64-column
  // block j / 4. Consecutive threads read consecutive pieces of a row.
  auto convert_chunk = [&](int c) {
    constexpr int P8 = D / 16;
    const int buf = c % ST, sbuf = c % SW;
#pragma unroll 1
    for (int i = 0; i < 2 * CK * P8 / kRaggedThreads; ++i) {
      const int idx = tid + kRaggedThreads * i;
      const int t = idx / (CK * P8), rem = idx - t * (CK * P8);
      const int key = rem / P8, j = rem - key * P8;
      uint4 lo, hi;
      e4m3x16_to_bf16(
          *reinterpret_cast<const uint4*>((t ? v8 : k8) + (buf * CK + key) * D + j * 16), lo, hi);
      unsigned char* blk = (t ? vs : ks) + (sbuf * NB + (j >> 2)) * kBlk;
      *reinterpret_cast<uint4*>(blk + sw128(key, (2 * j) & 7)) = lo;
      *reinterpret_cast<uint4*>(blk + sw128(key, (2 * j + 1) & 7)) = hi;
    }
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;
  // O += P V of the chunk in stage `buf`, P from pa, V read MN-major.
  uint32_t pa[CK / 16][4];
  auto pv_issue = [&](int sbuf) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint64_t db = mnmajor_desc(vs_a + sbuf * NB * kBlk + kk * 2048, kBlk);
      if constexpr (D == 128) wgmma_rs_n128<1>(o, pa[kk], db, 1);
      else wgmma_rs_n64<1>(o, pa[kk], db, 1);
    }
    wgmma_commit();
  };

#pragma unroll
  for (int c = 0; c < LA; ++c) load_chunk(c);
  // Software-pipelined (FlashAttention-3's intra-warpgroup overlap): in
  // iteration c the tensor cores run S = Q K_c^T and then O += P_{c-1}
  // V_{c-1}, and the softmax of chunk c (SIMT and exp2) runs while the
  // second product does; O is rescaled by chunk c's alpha once that
  // product is done, and P_c goes into the next iteration's.
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c % ST, sbuf = c % SW;
    cp_async_wait<LA - 1>();
    if constexpr (F8) {
      __syncthreads();  // chunk c's bytes landed; chunk c - 2's swizzled stage is free
      load_chunk(c + LA);
      convert_chunk(c);
      fence_proxy_async();
      __syncthreads();  // the converted chunk is visible to wgmma
    } else {
      fence_proxy_async();
      __syncthreads();  // chunk c landed; chunk c - 2's stage is free
      load_chunk(c + LA);
    }
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_n64<0>(s, qa[kk],
                      kmajor_desc(ks_a + sbuf * NB * kBlk + (kk >> 2) * kBlk + (kk & 3) * 32),
                      kk > 0);
    wgmma_commit();
    if (c > 0) {
      pv_issue((c - 1) % SW);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_operands(s);

    // Scale, mask and the online softmax (log2 units).
    float alpha[2];
    online_softmax_tile<CK / 8>(s, kpos_s + buf * CK, qpos, ctx + t0 + (wg * 64) / G, window,
                                sinks, scale_log2, tig, m_run, l_run, alpha);
    wgmma_wait<0>();  // O += P_{c-1} V_{c-1} is done
    fence_operands(o);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    // P_c: the accumulators of keys [16 kk, 16 kk + 16), rounded to bf16,
    // are the A fragment of k-step kk of P V.
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  if (n_chunks > 0) {
    pv_issue((n_chunks - 1) % SW);
    wgmma_wait<0>();
    fence_operands(o);
  }
  cp_async_wait<0>();  // the stages' empty groups

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wg * 64 + warp * 16 + gid + 8 * r;
    const int tok = t0 + row / G;
    if (tok >= n_tok) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow =
        out + (static_cast<size_t>(tok) * q_heads + h * G + row % G) * D + 2 * tig;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// The prefill kernel. Replaces the GQA arm of _prefill_kernel
// (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597). Grid (tiles,
// kv_heads, batch): tile t of row b is ragged_prefill_tile over the row's
// q_seq tokens at positions ctx_lens[b] + i and its keys [0, total_lens[b]),
// the tiles taken last first (a row's last tiles see the most keys). A
// padded token past total_lens - ctx attends the keys below total_lens, as
// the plain version's positions do. 256 threads and ~131 KB of shared
// memory a CTA (~116 KB for fp8), one CTA an SM. Its fp8 arm has no TPU
// kernel: it computes the JAX engine's XLA prefill of an fp8 pool.
template <int D, int G, bool F8>
__global__ void __launch_bounds__(kRaggedThreads, 1)
    prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, Hq, D]
                   const KvT<F8>* __restrict__ k,        // [P, Hkv, ps, D]
                   const KvT<F8>* __restrict__ v,
                   const int* __restrict__ page_table,  // [B, pps]
                   const int* __restrict__ ctx_lens,    // [B] cached before the new tokens
                   const int* __restrict__ total_lens,  // [B] ctx + valid new tokens
                   __nv_bfloat16* __restrict__ out,     // [B, S, Hq, D]
                   int q_seq, int kv_heads, int page_size, int pages_per_seq, int window,
                   int sinks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t seq = static_cast<size_t>(b) * q_seq * kv_heads * G * D;
  ragged_prefill_tile<D, G, F8>(q + seq, out + seq, k, v,
                            page_table + static_cast<size_t>(b) * pages_per_seq, q_seq,
                            tile * (kRaggedPrefillRows / G), ctx_lens[b], total_lens[b], h,
                            kv_heads, page_size, pages_per_seq, window, sinks, scale, smem);
}

// ---------------------------------------------------------------------------
// Ragged mixed prefill + decode. Replaces _ragged_kernel
// (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:736) and its decode-burst
// tail fold (has_tail, :829-838 and :936-956); its shared_kv arm (absorbed
// MLA) is latent_ragged_kernel in latent_attention.cu.
//
// One launch serves a flat token axis where row r's new tokens sit at flat
// slots [row_starts[r], row_starts[r+1]) at positions ctx_lens[r] + i. The
// TPU kernel cuts the flat axis into aligned q blocks that may straddle
// rows, walks every row a block touches and keeps per-query-row liveness
// selects, because its grid is sequential and BlockSpecs cut the arrays.
// Here each row goes to one of two arms of one kernel, by its length:
//
// - Decode arm: a row of 1..16 / G tokens (the engine's decode rows are 1
//   token) is a split_decode_tile, its (row, kv head) keys split across
//   n_split CTAs. A decode-only dispatch of 8 rows over 4160 keys with 8
//   kv heads of 128 is 68 MB, 0.020 ms at 3.35 TB/s. The wrapper picks
//   n_split from shapes only (rows, kv heads, the page table's capacity,
//   the SM count; ragged_decode_splits); a CTA whose row is not a decode row
//   exits at once. With n_split > 1 split_combine_kernel merges the splits
//   (counted with the launch).
// - Prefill arm: longer rows are cut into row-aligned tiles of QT = 128 /
//   G tokens x G heads, as in variable-length flash attention, each a
//   ragged_prefill_tile. Each warp of a CTA finds the CTA's row and tile
//   from row_starts itself (ragged_tile in attention_common.cuh: the rows'
//   tiles counted and prefix-summed by shuffles), the tiles taken last
//   first, so planning a launch needs no launch of its own.
//
// The decode-burst tail (TAIL; the tail instantiations exist only for it,
// so the other's decode arm carries none of it): a 1-token row with
// tail_lens[r] > 0 keeps its new KV in the dense tail [rows, T, Hkv, D] (of
// the pool's dtype): its paged keys are [0, ctx), its query sits at ctx +
// tail_len - 1, and its last split folds the tail as the decode kernel's
// does. Longer rows carry no tail (the JAX contract); theirs is ignored.
//
// The grid is (prefill CTAs, then decode CTAs) x kv_heads:
// ragged_tile_slots prefill CTAs (a bound on the tiles from shapes; surplus
// CTAs exit after helping zero the slots past row_starts[rows]) and rows x
// n_split decode CTAs, 256 threads each (a decode CTA's second warpgroup
// leaves at once); one CTA an SM.
// ---------------------------------------------------------------------------

template <int D, int G, bool TAIL, bool F8>
__global__ void __launch_bounds__(kRaggedThreads, 1)
    ragged_kernel(const __nv_bfloat16* __restrict__ q,  // [total_q, Hq, D]
                  const KvT<F8>* __restrict__ k,        // [P, Hkv, ps, D]
                  const KvT<F8>* __restrict__ v,
                  const int* __restrict__ page_table,  // [rows, pps]
                  const int* __restrict__ row_starts,  // [rows + 1] flat prefix sums
                  const int* __restrict__ ctx_lens,    // [rows] cached before the new tokens
                  const KvT<F8>* __restrict__ tail_k,  // [rows, T, Hkv, D] or null
                  const KvT<F8>* __restrict__ tail_v,
                  const int* __restrict__ tail_lens,   // [rows] valid tail slots
                  __nv_bfloat16* __restrict__ out,     // [total_q, Hq, D]
                  float* __restrict__ part_acc,        // [rows, Hkv, n_split, 16, D] when split
                  float* __restrict__ part_ml,         // [rows, Hkv, n_split, 2, 16] when split
                  int total_q, int rows, int kv_heads, int n_prefill, int n_split,
                  int page_size, int pages_per_seq, int tail_slots, int window, int sinks,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int h = blockIdx.y;
  const int q_heads = kv_heads * G;

  if (static_cast<int>(blockIdx.x) >= n_prefill) {  // the decode arm
    const int x = blockIdx.x - n_prefill;
    const int r = x / n_split, split = x - r * n_split;
    const int start = min(max(row_starts[r], 0), total_q);
    const int n_tok = min(max(row_starts[r + 1], start), total_q) - start;
    if (n_tok < 1 || n_tok > kDecodeRows / G || threadIdx.x >= kDecodeThreads) return;
    const size_t part = (static_cast<size_t>(r) * kv_heads + h) * n_split + split;
    const size_t off = static_cast<size_t>(start) * q_heads * D;
    const int ctx = ctx_lens[r];
    const int tail_len = TAIL && n_tok == 1 ? max(tail_lens[r], 0) : 0;
    const bool fold = tail_len > 0 && split == n_split - 1;
    const size_t tail_row = static_cast<size_t>(r) * tail_slots * kv_heads * D;
    split_decode_tile<D, G, TAIL, F8>(
        q + off, out + off, k, v, page_table + static_cast<size_t>(r) * pages_per_seq, n_tok,
        tail_len > 0 ? ctx + tail_len - 1 : ctx, tail_len > 0 ? ctx : ctx + n_tok, h, kv_heads,
        page_size, pages_per_seq, window, sinks, scale, smem, smem + RaggedSmem<D, F8>::kKpos,
        split, n_split, n_split > 1 ? part_acc + part * kDecodeRows * D : nullptr,
        n_split > 1 ? part_ml + part * 2 * kDecodeRows : nullptr,
        fold ? tail_k + tail_row : nullptr, fold ? tail_v + tail_row : nullptr,
        fold ? min(tail_len, tail_slots) : 0);
    return;
  }

  // The prefill arm: CTA x serves tile slot x (ragged_tile: the last tiles
  // first; a slot past the last tile exits).
  const int x = blockIdx.x;
  // Flat slots past the last row hold no token: zeros (this head group).
  const int real = min(max(row_starts[rows], 0), total_q);
  for (int j = real + x; j < total_q; j += n_prefill) {
    __nv_bfloat16* o = out + (static_cast<size_t>(j) * q_heads + h * G) * D;
    for (int i = threadIdx.x; i < G * D; i += kRaggedThreads) o[i] = __float2bfloat16_rn(0.f);
  }
  // Row and tile, clamped to the flat axis, so a malformed row_starts
  // cannot reach past q.
  const RaggedTile tile =
      ragged_tile(row_starts, rows, total_q, kRaggedPrefillRows / G, kDecodeRows / G, x);
  if (tile.row < 0) return;
  const int r = tile.row;
  const int ctx = ctx_lens[r];
  const size_t off = static_cast<size_t>(tile.start) * q_heads * D;
  ragged_prefill_tile<D, G, F8>(q + off, out + off, k, v,
                            page_table + static_cast<size_t>(r) * pages_per_seq, tile.len,
                            tile.t0, ctx, ctx + tile.len, h, kv_heads, page_size, pages_per_seq,
                            window, sinks, scale, smem);
}

// The combine pass of a split decode launch: CTA (row r x kv head h, tile
// row i) merges the n_split states of tile row i (token i / G, head h * G +
// i % G) of row r (merge_split_row). A ragged launch's row r holds the flat
// slots [row_starts[r], row_starts[r+1]) and is merged only when it took
// the decode arm; the decode kernel's (row_starts null) is one token at
// slot r. Rows past the row's tokens exit.
template <int D, int G>
__global__ void __launch_bounds__(kCombineThreads<D>)
    split_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                         const int* __restrict__ row_starts, __nv_bfloat16* __restrict__ out,
                         int total_q, int kv_heads, int n_split) {
  constexpr int R = kDecodeRows;
  const int p = blockIdx.x, i = blockIdx.y;
  const int r = p / kv_heads, h = p - r * kv_heads;
  int start = r, n_tok = 1;
  if (row_starts != nullptr) {
    start = min(max(row_starts[r], 0), total_q);
    n_tok = min(max(row_starts[r + 1], start), total_q) - start;
    if (n_tok < 1 || n_tok > R / G) return;
  }
  if (i / G >= n_tok) return;
  merge_split_row<D>(part_acc + (static_cast<size_t>(p) * n_split * R + i) * D,
                     static_cast<size_t>(R) * D,
                     part_ml + static_cast<size_t>(p) * n_split * 2 * R + i, 2 * R, R, n_split,
                     out + ((static_cast<size_t>(start) + i / G) * kv_heads * G + h * G + i % G) * D,
                     threadIdx.x);
}

// The split decode's workspace: part_acc of every (row, kv head, split),
// then part_ml.
void split_parts(void* workspace, int rows, int kv_heads, int head_dim, int n_split,
                 float** part_acc, float** part_ml) {
  *part_acc = static_cast<float*>(workspace);
  *part_ml = workspace == nullptr ? nullptr
                                  : *part_acc + static_cast<size_t>(rows) * kv_heads * n_split *
                                                    kDecodeRows * head_dim;
}

// Each launcher raises its kernel's shared-memory limit once, at its first
// call (a function-local static): never again, so never inside a CUDA-graph
// capture, whose callers warm up every launch first.
template <int D, int G, bool F8, bool TAIL>
int launch_decode_kernels(const void* q, const void* k, const void* v, const int* table,
                          const int* ctx_lens, const void* tail_k, const void* tail_v,
                          const int* tail_lens, void* out, int batch, int kv_heads,
                          int page_size, int pages_per_seq, int tail_slots, int window,
                          int sinks, float scale, int n_split, void* workspace,
                          cudaStream_t stream) {
  using KV = KvT<F8>;
  constexpr int smem = DecodeSmem<D, F8>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<D, G, TAIL, F8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float *part_acc, *part_ml;
  split_parts(workspace, batch, kv_heads, D, n_split, &part_acc, &part_ml);
  decode_kernel<D, G, TAIL, F8>
      <<<dim3(batch * kv_heads, n_split), kDecodeThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), table, ctx_lens, static_cast<const KV*>(tail_k),
          static_cast<const KV*>(tail_v), tail_lens, static_cast<__nv_bfloat16*>(out), part_acc, part_ml, kv_heads, page_size,
      pages_per_seq, tail_slots, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  split_combine_kernel<D, G><<<dim3(batch * kv_heads, G), kCombineThreads<D>, 0, stream>>>(
      part_acc, part_ml, nullptr, static_cast<__nv_bfloat16*>(out), batch, kv_heads, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G, bool F8>
int launch_decode(const void* q, const void* k, const void* v, const int* table,
                  const int* ctx_lens, const void* tail_k, const void* tail_v,
                  const int* tail_lens, void* out, int batch, int kv_heads, int page_size,
                  int pages_per_seq, int tail_slots, int window, int sinks, float scale,
                  int n_split, void* workspace, cudaStream_t stream) {
  return tail_k != nullptr
             ? launch_decode_kernels<D, G, F8, true>(q, k, v, table, ctx_lens, tail_k, tail_v,
                                                     tail_lens, out, batch, kv_heads, page_size,
                                                     pages_per_seq, tail_slots, window, sinks,
                                                     scale, n_split, workspace, stream)
             : launch_decode_kernels<D, G, F8, false>(q, k, v, table, ctx_lens, tail_k, tail_v,
                                                      tail_lens, out, batch, kv_heads,
                                                      page_size, pages_per_seq, tail_slots,
                                                      window, sinks, scale, n_split, workspace,
                                                      stream);
}

template <int D, int G, bool F8>
int launch_prefill(const void* q, const void* k, const void* v, const int* table,
                   const int* ctx_lens, const int* total_lens, void* out, int batch, int q_seq,
                   int kv_heads, int page_size, int pages_per_seq, int window, int sinks,
                   float scale, cudaStream_t stream) {
  using KV = KvT<F8>;
  constexpr int QT = kRaggedPrefillRows / G;
  constexpr int smem = RaggedSmem<D, F8>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<D, G, F8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((q_seq + QT - 1) / QT, kv_heads, batch);
  prefill_kernel<D, G, F8><<<grid, kRaggedThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), table, ctx_lens, total_lens,
      static_cast<__nv_bfloat16*>(out), q_seq, kv_heads, page_size, pages_per_seq, window, sinks,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G, bool F8, bool TAIL>
int launch_ragged_kernels(const void* q, const void* k, const void* v, const int* table,
                          const int* row_starts, const int* ctx_lens, const void* tail_k,
                          const void* tail_v, const int* tail_lens, void* out, int total_q,
                          int rows, int kv_heads, int page_size, int pages_per_seq,
                          int tail_slots, int window, int sinks, float scale, int n_split,
                          void* workspace, cudaStream_t stream) {
  using KV = KvT<F8>;
  constexpr int smem = RaggedSmem<D, F8>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ragged_kernel<D, G, TAIL, F8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_prefill = ragged_tile_slots(total_q, rows, kRaggedPrefillRows / G, kDecodeRows / G);
  float *part_acc, *part_ml;
  split_parts(workspace, rows, kv_heads, D, n_split, &part_acc, &part_ml);
  ragged_kernel<D, G, TAIL, F8><<<dim3(n_prefill + rows * n_split, kv_heads), kRaggedThreads,
                                  smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), table, row_starts, ctx_lens,
      static_cast<const KV*>(tail_k), static_cast<const KV*>(tail_v), tail_lens,
      static_cast<__nv_bfloat16*>(out), part_acc, part_ml, total_q, rows, kv_heads, n_prefill,
      n_split, page_size, pages_per_seq, tail_slots, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  split_combine_kernel<D, G><<<dim3(rows * kv_heads, kDecodeRows), kCombineThreads<D>, 0,
                              stream>>>(
      part_acc, part_ml, row_starts, static_cast<__nv_bfloat16*>(out), total_q, kv_heads,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G, bool F8>
int launch_ragged(const void* q, const void* k, const void* v, const int* table,
                  const int* row_starts, const int* ctx_lens, const void* tail_k,
                  const void* tail_v, const int* tail_lens, void* out, int total_q, int rows,
                  int kv_heads, int page_size, int pages_per_seq, int tail_slots, int window,
                  int sinks, float scale, int n_split, void* workspace, cudaStream_t stream) {
  return tail_k != nullptr
             ? launch_ragged_kernels<D, G, F8, true>(
                   q, k, v, table, row_starts, ctx_lens, tail_k, tail_v, tail_lens, out,
                   total_q, rows, kv_heads, page_size, pages_per_seq, tail_slots, window, sinks,
                   scale, n_split, workspace, stream)
             : launch_ragged_kernels<D, G, F8, false>(
                   q, k, v, table, row_starts, ctx_lens, tail_k, tail_v, tail_lens, out,
                   total_q, rows, kv_heads, page_size, pages_per_seq, tail_slots, window, sinks,
                   scale, n_split, workspace, stream);
}

#define LLMD_DISPATCH(FN, F8, D_, G_, ...)                        \
  switch (D_ * 100 + G_) {                                        \
    case 6401: return FN<64, 1, F8>(__VA_ARGS__);                 \
    case 6402: return FN<64, 2, F8>(__VA_ARGS__);                 \
    case 6404: return FN<64, 4, F8>(__VA_ARGS__);                 \
    case 6408: return FN<64, 8, F8>(__VA_ARGS__);                 \
    case 12801: return FN<128, 1, F8>(__VA_ARGS__);               \
    case 12802: return FN<128, 2, F8>(__VA_ARGS__);               \
    case 12804: return FN<128, 4, F8>(__VA_ARGS__);               \
    case 12808: return FN<128, 8, F8>(__VA_ARGS__);               \
    default: return -1;                                           \
  }

// The entry points' bodies, bf16 or fp8 pools.
template <bool F8>
int paged_decode(const void* q, const void* k, const void* v, const void* page_table,
                 const void* ctx_lens, const void* tail_k, const void* tail_v,
                 const void* tail_lens, void* out, int batch, int q_heads, int kv_heads,
                 int head_dim, int page_size, int pages_per_seq, int tail_slots, int window,
                 int sinks, float scale, int n_split, void* workspace, void* stream) {
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || n_split <= 0 || n_split > 65535 ||
      (n_split > 1 && workspace == nullptr))
    return -1;
  if (tail_k != nullptr &&
      (tail_v == nullptr || tail_lens == nullptr || tail_slots < 1 || tail_slots > kChunk))
    return -1;
  const int group = q_heads / kv_heads;
  LLMD_DISPATCH(launch_decode, F8, head_dim, group, q, k, v,
                static_cast<const int*>(page_table), static_cast<const int*>(ctx_lens), tail_k,
                tail_v, static_cast<const int*>(tail_lens), out, batch, kv_heads, page_size,
                pages_per_seq, tail_slots, window, sinks, scale, n_split, workspace,
                static_cast<cudaStream_t>(stream));
}

template <bool F8>
int paged_prefill(const void* q, const void* k, const void* v, const void* page_table,
                  const void* ctx_lens, const void* total_lens, void* out, int batch, int q_seq,
                  int q_heads, int kv_heads, int head_dim, int page_size, int pages_per_seq,
                  int window, int sinks, float scale, void* stream) {
  if (kv_heads <= 0 || kv_heads > 65535 || batch > 65535 || q_heads % kv_heads != 0)
    return -1;
  const int group = q_heads / kv_heads;
  LLMD_DISPATCH(launch_prefill, F8, head_dim, group, q, k, v,
                static_cast<const int*>(page_table), static_cast<const int*>(ctx_lens),
                static_cast<const int*>(total_lens), out, batch, q_seq, kv_heads, page_size,
                pages_per_seq, window, sinks, scale, static_cast<cudaStream_t>(stream));
}

template <bool F8>
int paged_ragged(const void* q, const void* k, const void* v, const void* page_table,
                 const void* row_starts, const void* ctx_lens, const void* tail_k,
                 const void* tail_v, const void* tail_lens, void* out,
                 int total_q, int rows, int q_heads, int kv_heads, int head_dim, int page_size,
                 int pages_per_seq, int tail_slots, int window, int sinks, float scale,
                 int n_split, void* workspace, void* stream) {
  if (kv_heads <= 0 || kv_heads > 65535 || q_heads % kv_heads != 0 || rows <= 0 ||
      total_q < 0 || n_split <= 0 || (n_split > 1 && workspace == nullptr))
    return -1;
  if (tail_k != nullptr &&
      (tail_v == nullptr || tail_lens == nullptr || tail_slots < 1 || tail_slots > kChunk))
    return -1;
  const int group = q_heads / kv_heads;
  LLMD_DISPATCH(launch_ragged, F8, head_dim, group, q, k, v,
                static_cast<const int*>(page_table), static_cast<const int*>(row_starts),
                static_cast<const int*>(ctx_lens), tail_k, tail_v,
                static_cast<const int*>(tail_lens), out, total_q, rows, kv_heads,
                page_size, pages_per_seq, tail_slots, window, sinks, scale, n_split, workspace,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// q [batch, q_heads, head_dim] bf16; k, v [pages, kv_heads, page_size,
// head_dim] bf16; page_table [batch, pages_per_seq] i32; ctx_lens [batch]
// i32 (paged keys to attend); out like q. The decode-burst tail: tail_k,
// tail_v [batch, tail_slots, kv_heads, head_dim] bf16 and tail_lens [batch]
// i32, 1 <= tail_slots <= 64, or all three null (no tail; the query sits at
// ctx_len - 1, else at ctx_len + tail_len - 1). window < 0: no sliding
// window. Each (row, kv head)'s keys are split across n_split CTAs (1 = no
// split, no combine pass); workspace holds llmd_decode_workspace_bytes.
// Returns 0 when the kernels launched. llmd_paged_decode_fp8 takes k, v,
// tail_k and tail_v of fp8 e4m3 (1 byte an element), the rest as above.
int llmd_paged_decode_bf16(const void* q, const void* k, const void* v, const void* page_table,
                           const void* ctx_lens, const void* tail_k, const void* tail_v,
                           const void* tail_lens, void* out, int batch, int q_heads,
                           int kv_heads, int head_dim, int page_size, int pages_per_seq,
                           int tail_slots, int window, int sinks, float scale, int n_split,
                           void* workspace, void* stream) {
  return paged_decode<false>(q, k, v, page_table, ctx_lens, tail_k, tail_v, tail_lens, out,
                             batch, q_heads, kv_heads, head_dim, page_size, pages_per_seq,
                             tail_slots, window, sinks, scale, n_split, workspace, stream);
}
int llmd_paged_decode_fp8(const void* q, const void* k, const void* v, const void* page_table,
                          const void* ctx_lens, const void* tail_k, const void* tail_v,
                          const void* tail_lens, void* out, int batch, int q_heads,
                          int kv_heads, int head_dim, int page_size, int pages_per_seq,
                          int tail_slots, int window, int sinks, float scale, int n_split,
                          void* workspace, void* stream) {
  return paged_decode<true>(q, k, v, page_table, ctx_lens, tail_k, tail_v, tail_lens, out,
                            batch, q_heads, kv_heads, head_dim, page_size, pages_per_seq,
                            tail_slots, window, sinks, scale, n_split, workspace, stream);
}

// q [batch, q_seq, q_heads, head_dim] bf16 (query i at ctx_len + i); k, v
// as above with the new tokens' KV already scattered (fp8 e4m3 for
// llmd_paged_prefill_fp8); ctx_lens, total_lens [batch] i32; out like q.
// Returns 0 when the kernel launched.
int llmd_paged_prefill_bf16(const void* q, const void* k, const void* v, const void* page_table,
                            const void* ctx_lens, const void* total_lens, void* out, int batch,
                            int q_seq, int q_heads, int kv_heads, int head_dim, int page_size,
                            int pages_per_seq, int window, int sinks, float scale,
                            void* stream) {
  return paged_prefill<false>(q, k, v, page_table, ctx_lens, total_lens, out, batch, q_seq,
                              q_heads, kv_heads, head_dim, page_size, pages_per_seq, window,
                              sinks, scale, stream);
}
int llmd_paged_prefill_fp8(const void* q, const void* k, const void* v, const void* page_table,
                           const void* ctx_lens, const void* total_lens, void* out, int batch,
                           int q_seq, int q_heads, int kv_heads, int head_dim, int page_size,
                           int pages_per_seq, int window, int sinks, float scale,
                           void* stream) {
  return paged_prefill<true>(q, k, v, page_table, ctx_lens, total_lens, out, batch, q_seq,
                             q_heads, kv_heads, head_dim, page_size, pages_per_seq, window,
                             sinks, scale, stream);
}

// Tokens per query tile of the prefill tiles (the prefill kernel's and the
// ragged kernel's prefill arm) for a GQA group: the unit in which the
// ragged kernel counts each prefill row's tiles (ragged_tile). -1 for a
// group the kernels do not take.
int llmd_ragged_tile_tokens(int group) {
  if (group != 1 && group != 2 && group != 4 && group != 8) return -1;
  return kRaggedPrefillRows / group;
}

// The most tokens a row may have to take the ragged kernel's decode arm
// (rows of 1..this many tokens own no prefill tile). -1 for a group the
// kernels do not take.
int llmd_ragged_decode_tokens(int group) {
  if (group != 1 && group != 2 && group != 4 && group != 8) return -1;
  return kDecodeRows / group;
}

// Tile slots of a ragged launch's prefill arm (ragged_tile_slots): the
// grid rule both ragged kernels size their prefill CTAs by, from shapes.
int llmd_ragged_tile_slots(int total_q, int rows, int tile_tokens, int decode_tokens) {
  return ragged_tile_slots(total_q, rows, tile_tokens, decode_tokens);
}

// Keys a split decode CTA (the decode kernel's, the ragged decode arm's)
// stages at a time: the caller sizes n_split with it.
int llmd_decode_chunk_keys() { return kChunk; }

// Bytes of fp32 workspace a split decode launch needs for n_split > 1 (O,
// m and l of every split of every (row, kv head)); 0 for n_split == 1.
long long llmd_decode_workspace_bytes(int rows, int kv_heads, int head_dim, int n_split) {
  if (n_split <= 1) return 0;
  return static_cast<long long>(rows) * kv_heads * n_split * kDecodeRows * (head_dim + 2) * 4;
}

// q [total_q, q_heads, head_dim] bf16, row r's tokens at flat slots
// [row_starts[r], row_starts[r+1]) at positions ctx_lens[r] + i, their KV
// already scattered; k, v as above; page_table [rows, pages_per_seq],
// row_starts [rows + 1] and ctx_lens [rows] i32. A row of at most
// llmd_ragged_decode_tokens(group) tokens takes the decode arm, a longer
// one ceil(len / llmd_ragged_tile_tokens(group)) prefill tiles, which the
// kernel finds from row_starts. Each decode row's keys are split across
// n_split CTAs (1 = no split, no combine pass); workspace holds
// llmd_decode_workspace_bytes. The decode-burst
// tail: tail_k, tail_v [rows, tail_slots, kv_heads, head_dim] (the pools'
// dtype) and tail_lens [rows] i32, 1 <= tail_slots <= 64, or all three null
// (no tail); a 1-token row with tail_len > 0 sits at ctx_len + tail_len - 1
// over its paged keys [0, ctx_len) and its tail, longer rows' tails are
// ignored. out like q, zeros past row_starts[rows]. llmd_paged_ragged_fp8
// takes fp8 e4m3 k, v, tail_k and tail_v. Returns 0 when the kernels
// launched.
int llmd_paged_ragged_bf16(const void* q, const void* k, const void* v, const void* page_table,
                           const void* row_starts, const void* ctx_lens, const void* tail_k,
                           const void* tail_v, const void* tail_lens,
                           void* out, int total_q, int rows, int q_heads, int kv_heads,
                           int head_dim, int page_size, int pages_per_seq, int tail_slots,
                           int window, int sinks, float scale, int n_split, void* workspace,
                           void* stream) {
  return paged_ragged<false>(q, k, v, page_table, row_starts, ctx_lens, tail_k,
                             tail_v, tail_lens, out, total_q, rows, q_heads, kv_heads, head_dim,
                             page_size, pages_per_seq, tail_slots, window, sinks, scale, n_split,
                             workspace, stream);
}
int llmd_paged_ragged_fp8(const void* q, const void* k, const void* v, const void* page_table,
                          const void* row_starts, const void* ctx_lens, const void* tail_k,
                          const void* tail_v, const void* tail_lens,
                          void* out, int total_q, int rows, int q_heads, int kv_heads,
                          int head_dim, int page_size, int pages_per_seq, int tail_slots,
                          int window, int sinks, float scale, int n_split, void* workspace,
                          void* stream) {
  return paged_ragged<true>(q, k, v, page_table, row_starts, ctx_lens, tail_k,
                            tail_v, tail_lens, out, total_q, rows, q_heads, kv_heads, head_dim,
                            page_size, pages_per_seq, tail_slots, window, sinks, scale, n_split,
                            workspace, stream);
}

}  // extern "C"
