// Wide-head paged attention over a single shared KV head for NVIDIA Hopper
// (sm_90a): flash decode and flash prefill for absorbed multi-head latent
// attention (DeepSeek-V2/V3 MLA) and multi-query attention. The pool is
// laid out [pages, 1, page_size, D] (one layer's view of the engine's
// [layers, ...] stack). In absorbed MLA each token caches one latent row of
// D = kv_lora_rank + qk_rope_head_dim (+ pad) values (576, or 640 in the
// TPU's lane-padded layout) that serves as the key AND the value of every
// query head: the G = num_heads query heads of a token attend over it as
// one multi-query group, and the output covers the full width D (the model
// keeps the first kv_lora_rank columns).
//
// Built by llmd_kv_cache_tpu_torch/ops/cuda_build.py beside
// paged_attention.cu into one plain-C shared library; the wrappers in
// llmd_kv_cache_tpu_torch/ops/cuda_paged_attention.py check shapes, types
// and devices and call the two entry points at the end of this file. Each
// returns cudaGetLastError() (0 = launched), or -1 for a shape it was not
// built for. Numerics and key visibility are those of paged_attention.cu:
// bf16 operands, fp32 scores times D^-0.5, masked scores at -1e30, an fp32
// online softmax, p rounded to bf16 before PV, out = acc / max(l, 1e-30);
// a masked key adds exactly 0, so a row with no key returns zeros.
//
// The decode kernel runs wide_tile (mma.sync): a decode row is a one-token
// prefill at position ctx_len - 1 over ctx_len keys, one live token per CTA.
// paged_attention.cu's split_decode_tile keeps each warp's Q fragments and
// O accumulators in registers, 16 rows x D wide: at D = 576 that is 144 +
// 288 registers a thread, past the 255 limit. wide_tile keeps the queries in
// shared memory, stages the scores of a key chunk (fp32, then p as bf16) in
// shared memory, and splits the O accumulators across warps by columns, so
// a thread holds at most D / 8 of them (80 at D = 640). The prefill kernel
// runs a wgmma tile of 64 rows instead (its note below). In both, each key
// chunk of the latent is staged in shared memory ONCE and feeds both
// products (QK^T reads it as K, PV as V): one HBM read per key, the point
// of caching only the latent. The TPU kernel's "copy" / "reuse" choice of
// how one VMEM buffer feeds two matmuls does not arise. With a separate V
// pool (MQA decode, shared = false) V chunks are staged beside K.
// ---------------------------------------------------------------------------

#include "hopper_common.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;

// Shared-memory layout of wide_tile: K (and V) chunks double-buffered, the
// tile's queries, fp32 scores, bf16 p, and per-row alpha and l. Row strides
// are padded by 8 bf16 (4 fp32) so fragment loads avoid bank conflicts.
template <int D, int ROWS, int CK, bool SHARED>
struct WideSmem {
  static constexpr int LD = D + 8;    // K / V / Q row (bf16)
  static constexpr int SLD = CK + 4;  // score row (fp32)
  static constexpr int PLD = CK + 8;  // p row (bf16)
  static constexpr int kKvElems = (SHARED ? 1 : 2) * 2 * CK * LD;
  static constexpr int kBytes =
      (kKvElems + ROWS * LD) * 2 + ROWS * SLD * 4 + ROWS * PLD * 2 + 2 * ROWS * 4;
};

// One tile of ROWS query rows of one sequence over its paged single-head
// KV. Rows are token-major: row r is head r % G of token t0 + r / G; token i
// of the sequence's n_tok new tokens sits at position ctx + i and is laid
// out [token, G, D] in q and out; the keys are [0, total) of the pages in
// `table`. Rows past n_tok compute nothing useful and are not written.
//
// Per key chunk of CK keys, with the 8 warps split as (m tile, slice):
//   1. S = Q K^T (mma.sync m16n8k16): each warp one m16 tile of rows and
//      CK / 8 / (8 / MT) n8 tiles of keys, over D / 16 k-steps; scaled and
//      masked into shared memory.
//   2. Online softmax: ROWS / 8 rows a warp, CK / 32 keys a lane; p (bf16)
//      and each row's alpha into shared memory, m and l in registers.
//   3. O = alpha O + P V: each warp one m16 tile and D / 8 / (8 / MT) n8
//      tiles of output columns, B fragments read key-major from the chunk.
//
// Split-KV: with n_split > 1 this CTA takes only the split-th of n_split
// equal runs of the tile's key chunks and, instead of the output, writes
// its unnormalised state to part_acc ([ROWS][D] fp32, O before the 1 / l)
// and part_ml ([2][ROWS]: the running max m, then l) for a combine pass. A
// split with no chunk writes m = -1e30, l = 0 and O = 0.
//
// Decode-burst tail: with tail_keys > 0 the CTA folds one more chunk after
// its paged ones, the first tail_keys rows of the dense [T, D] tail at
// tail_k (and tail_v unless SHARED), key j at position total + j; the
// remaining slots of the chunk are zero-filled and masked. The caller
// passes the query position (ctx) past the paged keys (total) and gives the
// tail to exactly one split of a row. The tail code exists only in the TAIL
// instantiations, so the paged loop of the others carries none of it.
template <int D, int G, int ROWS, int CK, bool SHARED, bool TAIL = false>
__device__ __forceinline__ void wide_tile(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ table, int n_tok, int t0, int ctx, int total, int page_size,
    int pages_per_seq, int window, int sinks, float scale, unsigned char* smem_raw,
    int split = 0, int n_split = 1, float* __restrict__ part_acc = nullptr,
    float* __restrict__ part_ml = nullptr, const __nv_bfloat16* __restrict__ tail_k = nullptr,
    const __nv_bfloat16* __restrict__ tail_v = nullptr, int tail_keys = 0) {
  using Smem = WideSmem<D, ROWS, CK, SHARED>;
  constexpr int LD = Smem::LD, SLD = Smem::SLD, PLD = Smem::PLD;
  constexpr int PIECES = D / 8;            // 16-byte pieces of a row
  constexpr int MT = ROWS / 16;            // m16 tiles of rows
  constexpr int WM = kWideWarps / MT;      // warps sharing an m tile
  constexpr int QK_NT = CK / 8 / WM;       // score n8 tiles a warp
  constexpr int PV_NT = D / 8 / WM;        // output n8 tiles a warp
  constexpr int KS = D / 16;               // k-steps of QK^T
  constexpr int RPW = ROWS / kWideWarps;   // softmax rows a warp
  constexpr int KPL = CK / 32;             // softmax keys a lane
  constexpr int QT = ROWS / G;             // tokens a tile
  static_assert(ROWS % 16 == 0 && kWideWarps % MT == 0 && ROWS % G == 0, "row tiling");
  static_assert((CK / 8) % WM == 0 && (D / 8) % WM == 0 && CK % 32 == 0, "column tiling");
  static_assert(KS % 2 == 0, "QK^T alternates two accumulators");

  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][CK][LD]
  __nv_bfloat16* vs = SHARED ? ks : ks + 2 * CK * LD;               // [2][CK][LD]
  __nv_bfloat16* qs = ks + Smem::kKvElems;                           // [ROWS][LD]
  float* ss = reinterpret_cast<float*>(qs + ROWS * LD);              // [ROWS][SLD]
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + ROWS * SLD);  // [ROWS][PLD]
  float* alpha_s = reinterpret_cast<float*>(ps + ROWS * PLD);        // [ROWS]
  float* l_s = alpha_s + ROWS;                                       // [ROWS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp % MT;  // this warp's m tile, in both products
  const int wn = warp / MT;  // its slice of the chunk's keys / of the columns
  const bool warp_live = t0 + (mt * 16) / G < n_tok;

  // The tile's queries (zeros for rows past n_tok): their own cp.async group.
  for (int i = tid; i < ROWS * PIECES; i += kWideThreads) {
    const int row = i / PIECES, part = i - row * PIECES;
    const int tok = t0 + row / G;
    const bool ok = tok < n_tok;
    const size_t src = (static_cast<size_t>(ok ? tok : 0) * G + row % G) * D + part * 8;
    cp_async_16(qs + row * LD + part * 8, q + src, ok);
  }
  cp_async_commit();

  // Keys the tile can see: up to its last query (causal), from the window
  // start of its first query, plus the sink pages.
  const int q_start = ctx + t0;
  int max_key = q_start + QT < total ? q_start + QT : total;
  if (max_key < 0) max_key = 0;
  const int num_pages = (max_key + page_size - 1) / page_size;
  const PageStream st =
      make_stream(num_pages, window >= 0 ? q_start - window + 1 : 0, page_size, sinks);
  const int n_chunks = (st.num_iters * page_size + CK - 1) / CK;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const int c_begin = min(split * per_split, n_chunks);
  const int c_end = min(c_begin + per_split, n_chunks);
  // Chunk c_end, when there is a tail, is the tail.
  const int c_stop = c_end + (TAIL && tail_keys > 0 ? 1 : 0);

  // The paged loads and the tail's are separate loops, so the paged loop
  // carries no tail branch.
  auto load_chunk = [&](int c, int buf) {
    if (TAIL && c == c_end) {
      for (int i = tid; i < CK * PIECES; i += kWideThreads) {
        const int key = i / PIECES, part = i - key * PIECES;
        const bool ok = key < tail_keys;
        const size_t off = static_cast<size_t>(ok ? key : 0) * D + part * 8;
        const int dst = (buf * CK + key) * LD + part * 8;
        cp_async_16(ks + dst, tail_k + off, ok);
        if (!SHARED) cp_async_16(vs + dst, tail_v + off, ok);
      }
    } else {
      for (int i = tid; i < CK * PIECES; i += kWideThreads) {
        const int key = i / PIECES, part = i - key * PIECES;
        int pidx = 0;
        const int pos = key_position(st, c * CK + key, page_size, pages_per_seq, total, &pidx);
        const bool ok = pos >= 0;
        const size_t phys = ok ? static_cast<size_t>(table[pidx]) : 0;
        const size_t off = (phys * page_size + (ok ? pos % page_size : 0)) * D + part * 8;
        const int dst = (buf * CK + key) * LD + part * 8;
        cp_async_16(ks + dst, k + off, ok);
        if (!SHARED) cp_async_16(vs + dst, v + off, ok);
      }
    }
    cp_async_commit();
  };

  float o_acc[PV_NT][4];
#pragma unroll
  for (int n = 0; n < PV_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }

  // Positions of this lane's two fragment rows (gid and gid + 8 of its m tile).
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = ctx + t0 + (mt * 16 + gid + 8 * r) / G;
  const __nv_bfloat16* qrow = qs + (mt * 16 + gid) * LD + 2 * tig;
  const __nv_bfloat16* prow = ps + (mt * 16 + gid) * PLD + 2 * tig;

  if (c_begin < c_stop) load_chunk(c_begin, 0);
  for (int c = c_begin; c < c_stop; ++c) {
    const int buf = (c - c_begin) & 1;
    if (c + 1 < c_stop) {
      load_chunk(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = ks + buf * CK * LD;
    const __nv_bfloat16* vb = vs + buf * CK * LD;

    // 1. Scores of this warp's 16 rows x QK_NT * 8 keys.
    if (warp_live) {
#pragma unroll
      for (int n = 0; n < QK_NT; ++n) {
        const int key0 = (wn * QK_NT + n) * 8;
        const __nv_bfloat16* krow = kb + (key0 + gid) * LD + 2 * tig;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; s += 2) {
          uint32_t qa[4];
          qa[0] = ld32(qrow + s * 16);
          qa[1] = ld32(qrow + 8 * LD + s * 16);
          qa[2] = ld32(qrow + s * 16 + 8);
          qa[3] = ld32(qrow + 8 * LD + s * 16 + 8);
          mma_16816(a0, qa, ld32(krow + s * 16), ld32(krow + s * 16 + 8));
          qa[0] = ld32(qrow + (s + 1) * 16);
          qa[1] = ld32(qrow + 8 * LD + (s + 1) * 16);
          qa[2] = ld32(qrow + (s + 1) * 16 + 8);
          qa[3] = ld32(qrow + 8 * LD + (s + 1) * 16 + 8);
          mma_16816(a1, qa, ld32(krow + (s + 1) * 16), ld32(krow + (s + 1) * 16 + 8));
        }
        // Element e: row gid + 8 * (e >> 1) of the m tile, key key0 + 2 * tig + (e & 1).
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          int pidx = 0;
          const int key = key0 + 2 * tig + j;
          const int kpos =
              TAIL ? decode_key_position(st, c, key, CK, c_end, tail_keys, total, page_size,
                                         pages_per_seq, total, &pidx)
                   : key_position(st, c * CK + key, page_size, pages_per_seq, total, &pidx);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float s = a0[2 * r + j] + a1[2 * r + j];
            ss[(mt * 16 + gid + 8 * r) * SLD + key] =
                attendable(kpos, qpos[r], window, sinks) ? s * scale : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // 2. Online softmax; l sums the fp32 p, PV takes p rounded to bf16.
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      float s[KPL];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[j] = ss[row * SLD + lane + 32 * j];
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run[i], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
        sum += p;
        ps[row * PLD + lane + 32 * j] = __float2bfloat16_rn(p);
      }
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(sum);
      m_run[i] = m_new;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // 3. O = alpha O + P V over this warp's columns.
    if (warp_live) {
      const float a_lo = alpha_s[mt * 16 + gid], a_hi = alpha_s[mt * 16 + gid + 8];
#pragma unroll
      for (int n = 0; n < PV_NT; ++n) {
        o_acc[n][0] *= a_lo;
        o_acc[n][1] *= a_lo;
        o_acc[n][2] *= a_hi;
        o_acc[n][3] *= a_hi;
      }
#pragma unroll
      for (int s = 0; s < CK / 16; ++s) {
        uint32_t pa[4];
        pa[0] = ld32(prow + s * 16);
        pa[1] = ld32(prow + 8 * PLD + s * 16);
        pa[2] = ld32(prow + s * 16 + 8);
        pa[3] = ld32(prow + 8 * PLD + s * 16 + 8);
        const __nv_bfloat16* v0 = vb + (s * 16 + 2 * tig) * LD + wn * PV_NT * 8 + gid;
#pragma unroll
        for (int n = 0; n < PV_NT; ++n) {
          uint32_t b0, b1;
          ld_b_kmajor<LD>(v0 + n * 8, b0, b1);
          mma_16816(o_acc[n], pa, b0, b1);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // the query group, when no key chunk was streamed

  if (part_acc != nullptr) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        part_ml[warp * RPW + i] = m_run[i];
        part_ml[ROWS + warp * RPW + i] = l_run[i];
      }
    }
    if (!warp_live) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* prow_acc = part_acc + (mt * 16 + gid + 8 * r) * D;
#pragma unroll
      for (int n = 0; n < PV_NT; ++n) {
        const int d = (wn * PV_NT + n) * 8 + 2 * tig;
        *reinterpret_cast<float2*>(prow_acc + d) = make_float2(o_acc[n][2 * r], o_acc[n][2 * r + 1]);
      }
    }
    return;
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) l_s[warp * RPW + i] = l_run[i];
  }
  __syncthreads();
  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = mt * 16 + gid + 8 * r;
    const int tok = t0 + row / G;
    if (tok >= n_tok) continue;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(tok) * G + row % G) * D;
#pragma unroll
    for (int n = 0; n < PV_NT; ++n) {
      const int d = (wn * PV_NT + n) * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o_acc[n][2 * r] * inv, o_acc[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Latent / multi-query decode. Replaces _decode_kernel
// (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:234), the per-(row, kv
// head) decode that the TPU wrapper runs when kv_heads == 1.
//
// The row's G query heads (one m16 tile; G = 8 fills half of it) over the
// single KV head's pages, 64-key chunks. Bound on the H100: bytes. At batch
// 8 over 4160-token contexts at D = 576 the latent is 8 * 4160 * 576 * 2 B
// = 38.3 MB a layer, 0.0114 ms at 3.35 TB/s, against 1.23 GFLOP of products
// (0.0012 ms). Each key is read from HBM once and feeds both products from
// shared memory. One CTA a row would be 8 CTAs on 132 SMs, and one SM's
// load rate, not the card's, would bound the launch; so each row's key
// chunks are split across n_split CTAs (flash-decoding: the wrapper picks
// n_split so that batch x n_split fills the SMs once), each writes its
// unnormalised O, m and l, and a combine pass rescales and sums them.
//
// The decode-burst tail (_tail_fold, :186; T <= 64 latents, 73 KB at width
// 576): the row's last split folds it as one more staged chunk, read from
// the dense tail instead of the pages, into its partial (m, l, O), which the
// combine pass merges like any other; with one split its CTA folds and
// writes the output. The query sits at ctx + tail_len - 1 (window and mask)
// while the paged keys stop at ctx. The split count comes from shapes, so at
// a small ctx the folding split may see no paged key: its state starts at
// m = -1e30 like any split's. The tail's p is rounded to bf16 for PV like
// every chunk's (the TPU fold keeps it fp32).
// ---------------------------------------------------------------------------

constexpr int kLatentDecodeRows = 16;
constexpr int kLatentDecodeChunk = 64;  // keys a chunk, and the most tail slots
constexpr int kCombineThreads = 128;

template <int D, int G, bool SHARED, bool TAIL>
__global__ void __launch_bounds__(kWideThreads, 1)
    latent_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, G, D]
                         const __nv_bfloat16* __restrict__ k,  // [P, 1, ps, D]
                         const __nv_bfloat16* __restrict__ v,  // as k; unread when SHARED
                         const int* __restrict__ page_table,   // [B, pps]
                         const int* __restrict__ ctx_lens,     // [B] paged keys to attend
                         const __nv_bfloat16* __restrict__ tail_k,  // [B, T, 1, D] or null
                         const __nv_bfloat16* __restrict__ tail_v,  // unread when SHARED
                         const int* __restrict__ tail_lens,         // [B] valid tail slots
                         __nv_bfloat16* __restrict__ out,           // [B, G, D]
                         float* __restrict__ part_acc,  // [B, n_split, 16, D] when split
                         float* __restrict__ part_ml,   // [B, n_split, 2, 16] when split
                         int page_size, int pages_per_seq, int tail_slots, int window,
                         int sinks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int ctx = ctx_lens[b];
  const int tail_len = TAIL ? max(tail_lens[b], 0) : 0;
  const bool fold = tail_len > 0 && split == n_split - 1;
  const size_t tail_row = static_cast<size_t>(b) * tail_slots * D;
  const size_t row = static_cast<size_t>(b) * G * D;
  const size_t part = static_cast<size_t>(b) * n_split + split;
  const bool to_parts = n_split > 1;
  wide_tile<D, G, kLatentDecodeRows, kLatentDecodeChunk, SHARED, TAIL>(
      q + row, out + row, k, v, page_table + static_cast<size_t>(b) * pages_per_seq, 1, 0,
      ctx + tail_len - 1, ctx, page_size, pages_per_seq, window, sinks, scale, smem_raw, split,
      n_split, to_parts ? part_acc + part * kLatentDecodeRows * D : nullptr,
      to_parts ? part_ml + part * 2 * kLatentDecodeRows : nullptr,
      fold ? tail_k + tail_row : nullptr, fold && !SHARED ? tail_v + tail_row : nullptr,
      fold ? min(tail_len, tail_slots) : 0);
}

// The combine pass of a split launch: row g of part p gets its n_split
// states merged (merge_split_row). Part p = b * tiles + tile holds R rows,
// rows tile * R + g of sequence b's rows_per_seq output rows: the latent
// decode has one part a row (tiles 1, R = 16, rows_per_seq = G), the latent
// prefill one a 64-row tile (rows_per_seq = q_seq * G). One CTA per (part,
// row), so the partials are read by parts x R CTAs.
template <int D, int R>
__global__ void __launch_bounds__(kCombineThreads)
    latent_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          __nv_bfloat16* __restrict__ out, int n_split, int tiles,
                          int rows_per_seq) {
  const int p = blockIdx.x, g = blockIdx.y;
  const int b = p / tiles, row = (p - b * tiles) * R + g;
  if (row >= rows_per_seq) return;
  merge_split_row<D>(part_acc + (static_cast<size_t>(p) * n_split * R + g) * D,
                     static_cast<size_t>(R) * D,
                     part_ml + static_cast<size_t>(p) * n_split * 2 * R + g, 2 * R, R, n_split,
                     out + (static_cast<size_t>(b) * rows_per_seq + row) * D, threadIdx.x,
                     kCombineThreads);
}

// ---------------------------------------------------------------------------
// Shared-latent prefill. Replaces the shared_kv arm of _prefill_kernel
// (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:597, which skips the V
// stream and reads the latent as V).
//
// New queries at positions ctx_len + i attend causally over the cached
// prefix and themselves (their latents already scattered). Bound on the
// H100: operations. A 2048-token chunk over a 2048-token prefix is ~6.29 M
// causal (query, key) pairs x 16 heads x 2 (576 + 576) FLOP = 232 GFLOP a
// layer, 0.234 ms at 989 TFLOP/s, against ~80 MB of traffic (0.024 ms).
//
// The design targets that bound with wgmma (FlashMLA's shape): one CTA of
// two warpgroups (256 threads) serves a 64-row tile, 4 tokens x the 16
// heads, all sharing the single latent head, so each staged key serves 64
// rows. The tile's queries are staged once, swizzled; each CK-key chunk of
// the latent is staged ONCE (cp.async, double-buffered) and feeds both
// products: Q K^T reads it K-major and P V reads the same bytes MN-major
// (wgmma's transpose bit), one HBM read per key. O (64 x D fp32, 147 KB
// at D = 576) is split by 64-column blocks across the two warpgroups:
// warpgroup 0 takes NB / 2 blocks and also computes the scores (m64nCKk16
// over D / 16 k-steps), the online softmax in registers, and p (bf16) and
// each row's rescale into shared memory; both then run P V (m64n128k16 /
// m64n64k16, A = p from shared memory) on their own columns. Two barriers
// a chunk; the scorer issues the next chunk's loads while its score wgmmas
// run, the softmax works in log2 units and skips the mask where every key
// is visible. Width 576: 64-key chunks, Q 72 KB + 2 x 72 KB + p 8 KB = 224
// KB of shared memory. Width 640 (the TPU's lane-padded latent): 32-key
// chunks, since two 80 KB stages and an 80 KB Q do not fit. What holds it
// back from the bound: the phases (scores, softmax, P V, loads) run one
// after another, the tensor cores idle through the softmax, and each 64-row
// tile re-stages every key up to its causal limit (the latent crosses L2
// once per 4 tokens); overlapping the phases, as the ragged prefill tile
// does, needs a second p buffer that the 227 KB do not hold at width 576.
//
// Split-KV for short chunks: when tiles x batch cannot fill the SMs (a
// 64-token warm chunk is 16 tiles), the wrapper (latent_prefill_splits,
// from shapes only) splits each tile's key chunks across n_split CTAs;
// each writes its unnormalised O, m and l, and latent_combine_kernel
// merges them (counted as one launch). CTAs take tiles longest-first (the
// last tiles of a chunk see the most keys).
// ---------------------------------------------------------------------------

constexpr int kLatentPrefillThreads = 256;
constexpr int kLatentPrefillRows = 64;  // one wgmma M tile: 4 tokens x 16 heads

template <int D>
struct LatentPrefillSmem {
  static constexpr int CK = D <= 576 ? 64 : 32;  // keys a chunk
  static constexpr int NB = D / 64;              // 64-column blocks
  static constexpr int NB0 = NB / 2;             // O blocks of warpgroup 0 (the scorer)
  static constexpr int kQ = NB * kLatentPrefillRows * 128;  // [NB][64 rows][128 B]
  static constexpr int kChunk = NB * CK * 128;              // [NB][CK keys][128 B]
  static constexpr int kP = kLatentPrefillRows * 128;       // [64 rows][64 keys] bf16
  static constexpr int kBytes =
      1024 + kQ + 2 * kChunk + kP + 2 * kLatentPrefillRows * 4 + 2 * CK * 4;
};

// One warpgroup's part of the tile loop. SCORER (warpgroup 0) computes the
// scores and the softmax; both run P V on NBW column blocks from `blk0`.
// Row r of the tile is head r % G of token t0 + r / G; rows past n_tok
// read zero queries and are not written.
template <int D, int G, int NBW, bool SCORER>
__device__ __forceinline__ void latent_prefill_wg(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ k, const int* __restrict__ table, int n_tok, int t0,
    int ctx, int total, int page_size, int pages_per_seq, int window, int sinks, float scale,
    unsigned char* smem, int split, int n_split, float* __restrict__ part_acc,
    float* __restrict__ part_ml) {
  using S = LatentPrefillSmem<D>;
  constexpr int CK = S::CK, NB = S::NB, PIECES = NB * 8;
  constexpr int QT = kLatentPrefillRows / G;
  constexpr int blk0 = SCORER ? 0 : S::NB0;
  static_assert(kLatentPrefillRows % G == 0 && D % 64 == 0, "tile shape");
  unsigned char* qs = smem;
  unsigned char* ks = qs + S::kQ;  // [2][kChunk]
  unsigned char* ps = ks + 2 * S::kChunk;
  float* alpha_s = reinterpret_cast<float*>(ps + S::kP);
  float* l_s = alpha_s + kLatentPrefillRows;
  int* kpos_s = reinterpret_cast<int*>(l_s + kLatentPrefillRows);  // [2][CK]

  const int tid = threadIdx.x;
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t qs_a = smem_addr(qs), ks_a = smem_addr(ks), ps_a = smem_addr(ps);

  // The tile's queries, their own cp.async group (both warpgroups copy).
  for (int i = tid; i < kLatentPrefillRows * PIECES; i += kLatentPrefillThreads) {
    const int row = i / PIECES, p = i - row * PIECES, b = p >> 3, pc = p & 7;
    const int tok = t0 + row / G;
    const bool ok = tok < n_tok;
    const size_t src = (static_cast<size_t>(ok ? tok : 0) * G + row % G) * D + p * 8;
    cp_async_16(qs + b * (kLatentPrefillRows * 128) + sw128(row, pc), q + src, ok);
  }
  cp_async_commit();

  // Keys the tile can see: up to its last query (causal), from the window
  // start of its first query, plus the sink pages.
  const int q_start = ctx + t0;
  int max_key = q_start + QT < total ? q_start + QT : total;
  if (max_key < 0) max_key = 0;
  const int num_pages = (max_key + page_size - 1) / page_size;
  const PageStream st =
      make_stream(num_pages, window >= 0 ? q_start - window + 1 : 0, page_size, sinks);
  const int n_chunks = (st.num_iters * page_size + CK - 1) / CK;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const int c_begin = min(split * per_split, n_chunks);
  const int c_end = min(c_begin + per_split, n_chunks);

  // TPK threads share a key: each computes the key's position once and
  // copies every TPK-th 16-byte piece of its row (consecutive threads on
  // consecutive pieces), and the first records the position for the mask.
  auto load_chunk = [&](int c, int buf) {
    constexpr int TPK = kLatentPrefillThreads / CK, PPT = PIECES / TPK;
    static_assert(PIECES % TPK == 0, "whole pieces a thread");
    const int key = tid / TPK, sub = tid % TPK;
    int pidx = 0;
    const int pos = key_position(st, c * CK + key, page_size, pages_per_seq, total, &pidx);
    const bool ok = pos >= 0;
    const __nv_bfloat16* src =
        k + (ok ? (static_cast<size_t>(table[pidx]) * page_size + pos % page_size) * D : 0);
    unsigned char* kb = ks + buf * S::kChunk;
    if (sub == 0) kpos_s[buf * CK + key] = pos;
#pragma unroll 1  // not unrolled: the O accumulators leave few registers
    for (int j = 0; j < PPT; ++j) {
      const int p = sub + j * TPK;
      cp_async_16(kb + (p >> 3) * (CK * 128) + sw128(key, p & 7), src + p * 8, ok);
    }
    cp_async_commit();
  };

  float o[NBW * 32];  // 64-column block j at o[32 j ...]
#pragma unroll
  for (int i = 0; i < NBW * 32; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = ctx + t0 + (warp * 16 + gid + 8 * r) / G;
  const float scale_log2 = scale * kLog2e;

  if (c_begin < c_end) load_chunk(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    named_barrier(1, kLatentPrefillThreads);  // chunk c (and Q) landed; chunk c - 1 is done
    const uint32_t kb_a = ks_a + buf * S::kChunk;
    // 1. S = Q K^T over D / 16 k-steps, both operands K-major; the scorer
    // issues its next loads while the tensor cores run, the other
    // warpgroup at once.
    float s[CK / 2];
    if (SCORER) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk >> 2, ks16 = (kk & 3) * 32;
        const uint64_t da = kmajor_desc(qs_a + b * (kLatentPrefillRows * 128) + ks16);
        const uint64_t db = kmajor_desc(kb_a + b * (CK * 128) + ks16);
        if constexpr (CK == 64) wgmma_ss_n64<0>(s, da, db, kk > 0);
        else wgmma_ss_n32<0>(s, da, db, kk > 0);
      }
      wgmma_commit();
    }
    if (c + 1 < c_end) load_chunk(c + 1, buf ^ 1);

    if (SCORER) {
      wgmma_wait<0>();
      fence_operands(s);

      // 2. Scale, mask and the online softmax (log2 units); p (bf16) goes
      // to shared memory as P V's A operand, each row's rescale beside it.
      float alpha[2];
      online_softmax_tile<CK / 8>(s, kpos_s + buf * CK, qpos, ctx + t0, window, sinks,
                                  scale_log2, tig, m_run, l_run, alpha);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + gid + 8 * r;
        if (tig == 0) alpha_s[row] = alpha[r];
#pragma unroll
        for (int j = 0; j < CK / 8; ++j)
          *reinterpret_cast<uint32_t*>(ps + sw128(row, j) + 4 * tig) =
              pack_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
      }
      fence_proxy_async();
    }
    named_barrier(2, kLatentPrefillThreads);  // p and the rescales of chunk c are ready

    // 3. O = alpha O + P V on this warpgroup's column blocks; V is the
    // staged chunk read MN-major.
    const float a_lo = alpha_s[warp * 16 + gid], a_hi = alpha_s[warp * 16 + gid + 8];
#pragma unroll
    for (int i = 0; i < NBW * 8; ++i) {
      o[4 * i] *= a_lo;
      o[4 * i + 1] *= a_lo;
      o[4 * i + 2] *= a_hi;
      o[4 * i + 3] *= a_hi;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint64_t da = kmajor_desc(ps_a + kk * 32);
#pragma unroll
      for (int j = 0; j + 1 < NBW; j += 2)
        wgmma_ss_n128<1>(*reinterpret_cast<float(*)[64]>(o + 32 * j), da,
                         mnmajor_desc(kb_a + (blk0 + j) * (CK * 128) + kk * 2048, CK * 128), 1);
      if constexpr (NBW % 2 == 1)
        wgmma_ss_n64<1>(*reinterpret_cast<float(*)[32]>(o + 32 * (NBW - 1)), da,
                        mnmajor_desc(kb_a + (blk0 + NBW - 1) * (CK * 128) + kk * 2048,
                                     CK * 128),
                        1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
  }
  cp_async_wait<0>();  // the query group, when no key chunk was streamed

  // This thread's outputs: rows 16 warp + gid (+ 8), columns 64 (blk0 + j)
  // + 8 n + 2 tig (+ 1) from o[32 j + 4 n + 2 r + e].
  if (part_acc != nullptr) {
    if (SCORER && tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part_ml[warp * 16 + gid + 8 * r] = m_run[r] * kLn2;  // natural units
        part_ml[kLatentPrefillRows + warp * 16 + gid + 8 * r] = l_run[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* prow = part_acc + (warp * 16 + gid + 8 * r) * D + blk0 * 64 + 2 * tig;
#pragma unroll
      for (int i = 0; i < NBW * 8; ++i)
        *reinterpret_cast<float2*>(prow + 8 * i) = make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
    }
    return;
  }
  if (SCORER && tig == 0) {
    l_s[warp * 16 + gid] = l_run[0];
    l_s[warp * 16 + gid + 8] = l_run[1];
  }
  named_barrier(1, kLatentPrefillThreads);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gid + 8 * r;
    const int tok = t0 + row / G;
    if (tok >= n_tok) continue;
    const float inv = 1.f / fmaxf(l_s[row], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<size_t>(tok) * G + row % G) * D + blk0 * 64 + 2 * tig;
#pragma unroll
    for (int i = 0; i < NBW * 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// Grid (tiles x n_split, batch): x = tile-major from the last tile, so the
// tiles with the most keys start first. With n_split > 1 each CTA writes
// its partial state to part_acc ([B, tiles, n_split, 64, D] fp32) and
// part_ml ([B, tiles, n_split, 2, 64]) for latent_combine_kernel.
template <int D, int G>
__global__ void __launch_bounds__(kLatentPrefillThreads, 1)
    latent_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, G, D]
                          const __nv_bfloat16* __restrict__ k,  // [P, 1, ps, D]
                          const int* __restrict__ page_table,   // [B, pps]
                          const int* __restrict__ ctx_lens,     // [B] cached before the new
                          const int* __restrict__ total_lens,   // [B] ctx + valid new tokens
                          __nv_bfloat16* __restrict__ out,      // [B, S, G, D]
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          int q_seq, int n_tiles, int n_split, int page_size,
                          int pages_per_seq, int window, int sinks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int b = blockIdx.y;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / n_split;
  const int split = blockIdx.x % n_split;
  const size_t seq = static_cast<size_t>(b) * q_seq * G * D;
  const size_t part = (static_cast<size_t>(b) * n_tiles + tile) * n_split + split;
  float* acc = n_split > 1 ? part_acc + part * kLatentPrefillRows * D : nullptr;
  float* ml = n_split > 1 ? part_ml + part * 2 * kLatentPrefillRows : nullptr;
  const int t0 = tile * (kLatentPrefillRows / G);
  using S = LatentPrefillSmem<D>;
  if (threadIdx.x < 128)
    latent_prefill_wg<D, G, S::NB0, true>(
        q + seq, out + seq, k, page_table + static_cast<size_t>(b) * pages_per_seq, q_seq, t0,
        ctx_lens[b], total_lens[b], page_size, pages_per_seq, window, sinks, scale, smem, split,
        n_split, acc, ml);
  else
    latent_prefill_wg<D, G, S::NB - S::NB0, false>(
        q + seq, out + seq, k, page_table + static_cast<size_t>(b) * pages_per_seq, q_seq, t0,
        ctx_lens[b], total_lens[b], page_size, pages_per_seq, window, sinks, scale, smem, split,
        n_split, acc, ml);
}

// Each launcher raises its kernel's shared-memory limit once, at its first
// call (a function-local static): never again, so never inside a CUDA-graph
// capture, whose callers warm up every launch first.
template <int D, int G, bool SHARED, bool TAIL>
int launch_latent_decode_kernels(const void* q, const void* k, const void* v, const int* table,
                                 const int* ctx_lens, const void* tail_k, const void* tail_v,
                                 const int* tail_lens, void* out, int batch, int page_size,
                                 int pages_per_seq, int tail_slots, int window, int sinks,
                                 float scale, int n_split, void* workspace,
                                 cudaStream_t stream) {
  constexpr int smem = WideSmem<D, kLatentDecodeRows, kLatentDecodeChunk, SHARED>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(latent_decode_kernel<D, G, SHARED, TAIL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml =
      part_acc == nullptr ? nullptr
                          : part_acc + static_cast<size_t>(batch) * n_split * kLatentDecodeRows * D;
  latent_decode_kernel<D, G, SHARED, TAIL>
      <<<dim3(batch, n_split), kWideThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), table, ctx_lens,
      static_cast<const __nv_bfloat16*>(tail_k), static_cast<const __nv_bfloat16*>(tail_v),
      tail_lens, static_cast<__nv_bfloat16*>(out), part_acc, part_ml, page_size,
      pages_per_seq, tail_slots, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  latent_combine_kernel<D, kLatentDecodeRows><<<dim3(batch, G), kCombineThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), n_split, 1, G);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G, bool SHARED>
int launch_latent_decode(const void* q, const void* k, const void* v, const int* table,
                         const int* ctx_lens, const void* tail_k, const void* tail_v,
                         const int* tail_lens, void* out, int batch, int page_size,
                         int pages_per_seq, int tail_slots, int window, int sinks, float scale,
                         int n_split, void* workspace, cudaStream_t stream) {
  return tail_k != nullptr
             ? launch_latent_decode_kernels<D, G, SHARED, true>(
                   q, k, v, table, ctx_lens, tail_k, tail_v, tail_lens, out, batch, page_size,
                   pages_per_seq, tail_slots, window, sinks, scale, n_split, workspace, stream)
             : launch_latent_decode_kernels<D, G, SHARED, false>(
                   q, k, v, table, ctx_lens, tail_k, tail_v, tail_lens, out, batch, page_size,
                   pages_per_seq, tail_slots, window, sinks, scale, n_split, workspace, stream);
}

template <int D, int G>
int launch_latent_prefill(const void* q, const void* k, const int* table, const int* ctx_lens,
                          const int* total_lens, void* out, int batch, int q_seq, int page_size,
                          int pages_per_seq, int window, int sinks, float scale, int n_split,
                          void* workspace, cudaStream_t stream) {
  constexpr int QT = kLatentPrefillRows / G;
  constexpr int smem = LatentPrefillSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      latent_prefill_kernel<D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (q_seq + QT - 1) / QT;
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml = part_acc == nullptr ? nullptr
                                       : part_acc + static_cast<size_t>(batch) * n_tiles *
                                                        n_split * kLatentPrefillRows * D;
  latent_prefill_kernel<D, G>
      <<<dim3(n_tiles * n_split, batch), kLatentPrefillThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), table,
      ctx_lens, total_lens, static_cast<__nv_bfloat16*>(out), part_acc, part_ml, q_seq, n_tiles,
      n_split, page_size, pages_per_seq, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  latent_combine_kernel<D, kLatentPrefillRows>
      <<<dim3(batch * n_tiles, kLatentPrefillRows), kCombineThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), n_split, n_tiles, q_seq * G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Keys a split CTA of the latent decode takes at a time: the caller sizes
// n_split with it (a split of fewer chunks than one would stream nothing).
int llmd_latent_decode_chunk_keys() { return kLatentDecodeChunk; }

// Bytes of fp32 workspace the latent decode needs for n_split > 1 (O, m and
// l of every split of every row); 0 for n_split == 1.
long long llmd_latent_decode_workspace_bytes(int batch, int head_dim, int n_split) {
  if (n_split <= 1) return 0;
  return static_cast<long long>(batch) * n_split * kLatentDecodeRows * (head_dim + 2) * 4;
}

// q [batch, q_heads, head_dim] bf16; k (and v unless shared_kv) [pages, 1,
// page_size, head_dim] bf16; page_table [batch, pages_per_seq] i32;
// ctx_lens [batch] i32 (paged keys to attend); out like q. The decode-burst
// tail: tail_k (and tail_v unless shared_kv) [batch, tail_slots, 1,
// head_dim] bf16 and tail_lens [batch] i32, 1 <= tail_slots <= 64, or
// tail_k null (no tail; the query sits at ctx_len - 1, else at ctx_len +
// tail_len - 1). Each row's key chunks are split across n_split CTAs (1 =
// no split, no combine pass); workspace holds
// llmd_latent_decode_workspace_bytes. Built: shared_kv at head_dim 576 or
// 640 with 16 query heads (absorbed MLA); separate V at head_dim 128 with 8
// or 16 query heads (MQA). window < 0: no sliding window. Returns 0 when
// the kernels launched.
int llmd_latent_decode_bf16(const void* q, const void* k, const void* v, const void* page_table,
                            const void* ctx_lens, const void* tail_k, const void* tail_v,
                            const void* tail_lens, void* out, int batch, int q_heads,
                            int head_dim, int shared_kv, int page_size, int pages_per_seq,
                            int tail_slots, int window, int sinks, float scale, int n_split,
                            void* workspace, void* stream) {
  const int* table = static_cast<const int*>(page_table);
  const int* ctx = static_cast<const int*>(ctx_lens);
  const int* tl = static_cast<const int*>(tail_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_split <= 0 || n_split > 65535 || (n_split > 1 && workspace == nullptr))
    return -1;
  if (tail_k != nullptr && (tail_lens == nullptr || (!shared_kv && tail_v == nullptr) ||
                            tail_slots < 1 || tail_slots > kLatentDecodeChunk))
    return -1;
  if (shared_kv && q_heads == 16 && head_dim == 576)
    return launch_latent_decode<576, 16, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
                                               batch, page_size, pages_per_seq, tail_slots,
                                               window, sinks, scale, n_split, workspace, s);
  if (shared_kv && q_heads == 16 && head_dim == 640)
    return launch_latent_decode<640, 16, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
                                               batch, page_size, pages_per_seq, tail_slots,
                                               window, sinks, scale, n_split, workspace, s);
  if (!shared_kv && q_heads == 8 && head_dim == 128)
    return launch_latent_decode<128, 8, false>(q, k, v, table, ctx, tail_k, tail_v, tl, out,
                                               batch, page_size, pages_per_seq, tail_slots,
                                               window, sinks, scale, n_split, workspace, s);
  if (!shared_kv && q_heads == 16 && head_dim == 128)
    return launch_latent_decode<128, 16, false>(q, k, v, table, ctx, tail_k, tail_v, tl, out,
                                                batch, page_size, pages_per_seq, tail_slots,
                                                window, sinks, scale, n_split, workspace, s);
  return -1;
}

// Tokens a latent prefill tile takes (16 query heads a token), the keys a
// chunk at this width (0 for an unbuilt width) and the bytes of fp32
// workspace a launch of n_split > 1 needs (0 for n_split == 1): the caller
// plans the split from these.
int llmd_latent_prefill_tile_tokens() { return kLatentPrefillRows / 16; }
int llmd_latent_prefill_chunk_keys(int head_dim) {
  if (head_dim == 576) return LatentPrefillSmem<576>::CK;
  if (head_dim == 640) return LatentPrefillSmem<640>::CK;
  return 0;
}
long long llmd_latent_prefill_workspace_bytes(int batch, int q_seq, int head_dim, int n_split) {
  if (n_split <= 1) return 0;
  const long long tiles = (q_seq + kLatentPrefillRows / 16 - 1) / (kLatentPrefillRows / 16);
  return static_cast<long long>(batch) * tiles * n_split * kLatentPrefillRows * (head_dim + 2) * 4;
}

// q [batch, q_seq, q_heads, head_dim] bf16 (query i at ctx_len + i); k the
// latent pool [pages, 1, page_size, head_dim] bf16 with the new tokens'
// latents already scattered (it is also V); ctx_lens, total_lens [batch]
// i32; out like q. Each tile's key chunks are split across n_split CTAs (1
// = no split, no combine pass); workspace holds
// llmd_latent_prefill_workspace_bytes. Built: head_dim 576 or 640 with 16
// query heads. Returns 0 when the kernels launched.
int llmd_latent_prefill_bf16(const void* q, const void* k, const void* page_table,
                             const void* ctx_lens, const void* total_lens, void* out, int batch,
                             int q_seq, int q_heads, int head_dim, int page_size,
                             int pages_per_seq, int window, int sinks, float scale, int n_split,
                             void* workspace, void* stream) {
  const int* table = static_cast<const int*>(page_table);
  const int* ctx = static_cast<const int*>(ctx_lens);
  const int* total = static_cast<const int*>(total_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || q_seq <= 0 || n_split <= 0 ||
      (n_split > 1 && workspace == nullptr))
    return -1;
  if (q_heads == 16 && head_dim == 576)
    return launch_latent_prefill<576, 16>(q, k, table, ctx, total, out, batch, q_seq, page_size,
                                          pages_per_seq, window, sinks, scale, n_split,
                                          workspace, s);
  if (q_heads == 16 && head_dim == 640)
    return launch_latent_prefill<640, 16>(q, k, table, ctx, total, out, batch, q_seq, page_size,
                                          pages_per_seq, window, sinks, scale, n_split,
                                          workspace, s);
  return -1;
}

}  // extern "C"
