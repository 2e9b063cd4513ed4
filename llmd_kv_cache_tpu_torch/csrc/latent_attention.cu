// Wide-head paged attention over a single shared KV head for NVIDIA Hopper
// (sm_90a): flash decode, flash prefill and ragged mixed prefill + decode
// for absorbed multi-head latent attention (DeepSeek-V2/V3 MLA), and flash
// decode for multi-query attention. The pool is
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
// and devices and call the entry points at the end of this file. Each
// returns cudaGetLastError() (0 = launched), or -1 for a shape it was not
// built for. Numerics and key visibility are those of paged_attention.cu:
// bf16 operands, fp32 scores times D^-0.5, masked scores at -1e30, an fp32
// online softmax, p rounded to bf16 before PV, out = acc / max(l, 1e-30);
// a masked key adds exactly 0, so a row with no key returns zeros.
//
// The decode kernel runs latent_split_decode_tile (mma.sync, two pipelines
// of 4 warps a CTA): the row's 16 query rows over one split of its keys,
// Q K^T split across a pipeline's warps by the reduction axis and P V by
// output columns, so that a thread holds a quarter of Q's fragments and of
// O's accumulators (36 + 72 registers at D = 576, where one warp holding
// all 16 rows x D would need 144 + 288); a combine pass merges the splits
// (its note below). The
// prefill kernel runs a wgmma tile of 64 rows instead (its note below), and
// the ragged kernel runs each row on one of the two tiles. In all of them,
// each key chunk of the latent is staged in shared memory ONCE and
// feeds both products (QK^T reads it as K, PV as V): one HBM read per key,
// the point of caching only the latent. The TPU kernel's "copy" / "reuse"
// choice of how one VMEM buffer feeds two matmuls does not arise. With a
// separate V pool (MQA decode, shared = false) V chunks are staged beside
// K.
// ---------------------------------------------------------------------------

#include "hopper_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Latent / multi-query decode. Replaces _decode_kernel
// (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:234), the per-(row, kv
// head) decode that the TPU wrapper runs when kv_heads == 1, with its
// decode-burst tail fold (_tail_fold, :186, folded at :364).
//
// The row's G query heads (one m16 tile; G = 8 fills half of it) over the
// single KV head's pages. Bound on the H100: bytes. At batch 8 over
// 4160-token contexts at D = 576 the latent is 8 * 4160 * 576 * 2 B = 38.3
// MB a layer, 0.0114 ms at 3.35 TB/s, against 1.23 GFLOP of products
// (0.0012 ms). Each key is read from HBM once and feeds both products from
// shared memory. One CTA a row would leave one SM's load rate, not the
// card's, to bound the launch, so each row's key chunks are split across
// n_split CTAs (flash-decoding; latent_decode_splits plans them from shapes,
// one CTA an SM), each writes its unnormalised O, m and l, and
// latent_combine_kernel rescales and sums them. Under tensor parallelism
// each rank runs its 16 / tp local heads (G = 8 at tp 2) over the whole
// replicated latent: its bytes, and so its bound, are the 16-head
// kernel's, and tp takes no time off the attention of MLA decode.
//
// latent_split_decode_tile: two teams of 4 warps a CTA, each team an
// independent pipeline over half of the split's 32-key chunks (two cp.async
// stages each, so an SM keeps two chunks in flight), merged in shared
// memory at the end: one partial state and one query load a CTA for two
// pipelines. ~182 KB of shared memory at D = 576, one CTA an SM. What it
// does about what held the wide tile back:
// - Key metadata a chunk ahead. A team's warp 0 stages each key's pool row
//   address (null: zero-filled) and a 32-bit mask of the keys the query may
//   see one chunk before their copies, its page-table load issued before the
//   score products and stored after them; the copy loop does no division
//   and no table load, and consecutive threads copy consecutive 16-byte
//   pieces of a 1152-byte row. cp.async, not TMA: a chunk spans pages at
//   their own ids; a bulk copy per row (the TMA engine without a tensor
//   map, keeping the padded stride) measured no faster.
// - Q in registers, split by columns. A team's Q K^T is split across its
//   warps by the reduction axis: warp w takes k-steps [w KS, (w + 1) KS),
//   KS = D / 64 (36 registers of Q fragments a thread at D = 576, loaded
//   once by ldmatrix_x4 from the staged query) for all 32 keys, K's B
//   fragments by ldmatrix_x4. The warps' partial scores are the one
//   exchange a chunk: each warp adds all four (float4 stores and loads, the
//   same lane layout in every warp, summed in warp order, so every warp
//   holds the same full scores) and runs the online softmax itself; p stays
//   in registers as the A fragment of P V, and no row statistic crosses
//   warps.
// - O split across a team's warps by columns (D / 4 each, 72 fp32
//   registers a thread at D = 576), V's B fragments by ldmatrix_x4_trans.
// - Two barriers a chunk (a team's named barrier): one publishes the chunk
//   (and frees the stage and the partial scores of the chunk before), one
//   the partial scores and the metadata staged a chunk ahead.
// - The tail off the paged loop: the burst tail's slots come in as the
//   metadata of one or two more chunks of the row's last split (row
//   addresses in the dense tail, positions total + j), folded by its second
//   team, so the loop of the TAIL instantiation is the plain one's; the
//   tail's p is rounded to bf16 for P V like every chunk's (the TPU fold
//   keeps it fp32).
// What holds it from the bound: the partial states (16 x D fp32 a CTA,
// written and read back by the combine pass), each CTA's ramp (query,
// metadata, first chunk) before its two pipelines stream, and the rate the
// two pipelines an SM reach.
// The split count comes from shapes only, so at a small ctx the folding
// split may see no paged key: its state starts at m = -1e30 like any
// split's. A split with no chunk writes m = -1e30, l = 0 and O = 0.
// ---------------------------------------------------------------------------

constexpr int kLatentDecodeRows = 16;
constexpr int kLatentDecodeTeams = 2;          // independent 4-warp pipelines a CTA
constexpr int kLatentDecodeTeamThreads = 128;
constexpr int kLatentDecodeThreads = kLatentDecodeTeams * kLatentDecodeTeamThreads;
constexpr int kLatentDecodeWarps = kLatentDecodeTeamThreads / 32;  // a team's
constexpr int kLatentDecodeChunk = 32;      // keys a chunk
constexpr int kLatentDecodeStages = 2;      // a team's chunks staged: one in use, one loading
constexpr int kLatentDecodeTailSlots = 64;  // the most tail slots (two chunks)
// CTAs an SM holds at once (its shared memory; the launch bound), which
// the split plan fills once: the library exports it to the planner.
constexpr int kLatentDecodeCtasPerSm = 1;

// Shared memory of latent_split_decode_tile: the query tile, staged once
// for both teams; each team's kLatentDecodeStages stages of K (and V unless
// SHARED) in padded rows, its partial scores, and the key metadata of PS
// chunks (row addresses of K, and of V unless SHARED; the visibility
// masks); the second team's m and l for the final merge (its O goes
// through its stages).
template <int D, bool SHARED>
struct LatentDecodeSmem {
  static constexpr int CK = kLatentDecodeChunk, ST = kLatentDecodeStages;
  static constexpr int PS = ST + 1;  // metadata of the stages' chunks and the next one
  static constexpr int LD = D + 8;   // padded row: conflict-free ldmatrix rows
  static constexpr int kStage = (SHARED ? 1 : 2) * CK * LD * 2;
  static constexpr int kQ = kLatentDecodeRows * LD * 2;
  static constexpr int kS = kLatentDecodeWarps * (CK / 8) * 32 * 16;  // float4 [warp][tile][lane]
  static constexpr int kPtrs = PS * CK * (SHARED ? 1 : 2) * 8;
  static constexpr int kTeam = (ST * kStage + kS + kPtrs + PS * 4 + 15) / 16 * 16;
  static constexpr int kBytes = kQ + kLatentDecodeTeams * kTeam + 2 * kLatentDecodeRows * 4;
  static_assert(kLatentDecodeRows * D * 4 <= ST * kStage, "the merge's O fits the stages");
  // 228 KB an SM, 1 KB of it reserved a CTA.
  static_assert(kLatentDecodeCtasPerSm * (kBytes + 1024) <= 233472,
                "kLatentDecodeCtasPerSm CTAs fit an SM");
};

// One decode row of G heads (rows past G read zero queries and are not
// written) at position q_pos over the split-th of n_split equal runs of the
// row's CK-key chunks of its paged keys [0, total), from the window start,
// plus the sink pages; team 0 takes the first half of the run, team 1 the
// rest and, with tail_keys > 0 (TAIL, the last split only), the first
// tail_keys rows of the dense [T, D] tail at tail_k (and tail_v) at
// positions total + j as ceil(tail_keys / CK) more chunks. At the end team
// 1's state merges into team 0's, which writes the output or the partial.
template <int D, int G, bool SHARED, bool TAIL>
__device__ __forceinline__ void latent_split_decode_tile(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ table, int q_pos, int total, int page_size, int pages_per_seq,
    int window, int sinks, float scale, unsigned char* smem, int split, int n_split,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const __nv_bfloat16* __restrict__ tail_k, const __nv_bfloat16* __restrict__ tail_v,
    int tail_keys) {
  using S = LatentDecodeSmem<D, SHARED>;
  constexpr int CK = S::CK, ST = S::ST, PS = S::PS, LD = S::LD;
  constexpr int R = kLatentDecodeRows, W = kLatentDecodeWarps, TT = kLatentDecodeTeamThreads;
  constexpr int PIECES = D / 8;          // 16-byte pieces of a row
  constexpr int KS = D / 16 / W;         // Q K^T k-steps a warp
  constexpr int NT = CK / 8;             // score n8 tiles of a chunk
  constexpr int NO = D / 8 / W;          // output n8 tiles a warp
  static_assert(D % (16 * W) == 0 && NO % 2 == 0, "column split across the warps");
  static_assert(CK == 32 && G <= R, "a key a lane of warp 0; one m16 tile");
  static_assert(CK * PIECES % TT == 0, "whole copy passes");

  const int tid = threadIdx.x, team = tid / TT, ttid = tid % TT;
  const int warp = ttid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [R][LD]
  unsigned char* ts = smem + S::kQ + team * S::kTeam;           // this team's region
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ts);     // [ST][CK][LD] (K, V)
  float4* sp = reinterpret_cast<float4*>(ts + ST * S::kStage);  // [W][NT][32]
  const __nv_bfloat16** kp_s =
      reinterpret_cast<const __nv_bfloat16**>(ts + ST * S::kStage + S::kS);  // [PS][CK]
  const __nv_bfloat16** vp_s = SHARED ? kp_s : kp_s + PS * CK;                // [PS][CK]
  unsigned* vis_s = reinterpret_cast<unsigned*>(ts + ST * S::kStage + S::kS + S::kPtrs);  // [PS]
  float* ml_s = reinterpret_cast<float*>(smem + S::kQ + kLatentDecodeTeams * S::kTeam);

  const int num_pages = (total + page_size - 1) / page_size;
  const PageStream st =
      make_stream(num_pages, window >= 0 ? q_pos - window + 1 : 0, page_size, sinks);
  const int n_chunks = (st.num_iters * page_size + CK - 1) / CK;
  const int per_split = (n_chunks + n_split - 1) / n_split;
  const int s_begin = min(split * per_split, n_chunks);
  const int s_end = min(s_begin + per_split, n_chunks);
  const int half = (s_end - s_begin + 1) / 2;
  // This team's chunks [c_begin, c_stop); team 1's from s_end on, when the
  // split folds a tail, are the tail.
  const int c_begin = team == 0 ? s_begin : s_begin + half;
  const int c_stop = team == 0 ? s_begin + half
                               : s_end + (TAIL ? (tail_keys + CK - 1) / CK : 0);

  // Key metadata of chunk c, by the team's warp 0, one key a lane, into
  // slot (c - c_begin) % PS: meta_load issues the page-table load,
  // meta_store (after the score products, so that the load's latency
  // passes under them) the row addresses and the visibility mask.
  struct Meta {
    int pos, phys;
  };
  auto meta_load = [&](int c) {
    Meta m{-1, 0};
    if (warp == 0 && c < c_stop) {
      if (TAIL && c >= s_end) {
        const int j = (c - s_end) * CK + lane;
        m.pos = j < tail_keys ? total + j : -1;
      } else {
        int pidx = 0;
        m.pos = key_position(st, c * CK + lane, page_size, pages_per_seq, total, &pidx);
        if (m.pos >= 0) m.phys = table[pidx];
      }
    }
    return m;
  };
  auto meta_store = [&](int c, const Meta& m) {
    if (warp == 0 && c < c_stop) {
      const int slot = (c - c_begin) % PS;
      const __nv_bfloat16 *kp = nullptr, *vp = nullptr;
      if (m.pos >= 0) {
        const bool in_tail = TAIL && c >= s_end;
        const size_t off =
            in_tail ? static_cast<size_t>(m.pos - total) * D
                    : (static_cast<size_t>(m.phys) * page_size + m.pos % page_size) * D;
        kp = (in_tail ? tail_k : k) + off;
        if (!SHARED) vp = (in_tail ? tail_v : v) + off;
      }
      kp_s[slot * CK + lane] = kp;
      if (!SHARED) vp_s[slot * CK + lane] = vp;
      const unsigned vis = __ballot_sync(0xffffffffu, attendable(m.pos, q_pos, window, sinks));
      if (lane == 0) vis_s[slot] = vis;
    }
  };
  // Chunk c's rows into stage (c - c_begin) % ST from its staged row
  // addresses: team thread t copies pieces t, t + 128, ... of the chunk, so
  // that consecutive threads copy consecutive 16-byte pieces of a row (a
  // masked key's row is zero-filled). Past the team's last chunk it commits
  // an empty group, so that every iteration waits for the same count.
  auto load_chunk = [&](int c) {
    if (c < c_stop) {
      const int slot = (c - c_begin) % PS;
      __nv_bfloat16* kb = ks + (c - c_begin) % ST * (S::kStage / 2);
#pragma unroll
      for (int j = 0; j < CK * PIECES / TT; ++j) {
        const int i = ttid + j * TT;
        const int key = i / PIECES, piece = i - key * PIECES;
        const __nv_bfloat16* src = kp_s[slot * CK + key];
        cp_async_16(kb + key * LD + piece * 8, src ? src + piece * 8 : k, src != nullptr);
        if (!SHARED) {
          const __nv_bfloat16* vsrc = vp_s[slot * CK + key];
          cp_async_16(kb + (CK + key) * LD + piece * 8, vsrc ? vsrc + piece * 8 : v,
                      vsrc != nullptr);
        }
      }
    }
    cp_async_commit();
  };

  // The query tile (zeros past G), by both teams, its own cp.async group;
  // then each team's metadata of its first ST chunks and the copies of its
  // first ST - 1, issued before the query's wait.
  for (int i = tid; i < R * PIECES; i += kLatentDecodeThreads) {
    const int row = i / PIECES, piece = i - row * PIECES;
    const bool ok = row < G;
    cp_async_16(qs + row * LD + piece * 8, q + (ok ? row * D + piece * 8 : 0), ok);
  }
  cp_async_commit();
  {
    Meta first[ST];  // the table loads in flight together
#pragma unroll
    for (int i = 0; i < ST; ++i) first[i] = meta_load(c_begin + i);
#pragma unroll
    for (int i = 0; i < ST; ++i) meta_store(c_begin + i, first[i]);
  }
  named_barrier(1 + team, TT);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load_chunk(c_begin + i);
  cp_async_wait<ST - 1>();
  __syncthreads();  // the query landed (every thread's copies of it)
  // This warp's Q fragments: ldmatrix_x4 matrix i (lanes 8 i ..) is rows
  // 8 (i & 1) .., columns 8 (i >> 1) .. of a k-step: a0..a3 of mma's A.
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qf = qs + (lane & 15) * LD + (lane >> 4) * 8 + warp * KS * 16;
#pragma unroll
    for (int s = 0; s < KS; ++s) ldmatrix_x4(qa[s], qf + s * 16);
  }

  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // ldmatrix row addresses. K (not transposed): matrix i is keys [16 np +
  // 8 (i >> 1), +8) x dims [8 (i & 1), +8) of a k-step, so registers 0-3
  // are b0, b1 of key tiles 2 np and 2 np + 1. V (transposed): matrix i is
  // keys [16 kk + 8 (i & 1), +8) x columns [16 j + 8 (i >> 1), +8) of this
  // warp's, so registers 0-3 are b0, b1 of column tiles 2 j and 2 j + 1.
  const int k_ld = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1) + warp * KS * 16;
  const int v_ld = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4) + warp * NO * 8 +
                   (SHARED ? 0 : CK * LD);

  for (int c = c_begin; c < c_stop; ++c) {
    const int slot = (c - c_begin) % PS;
    const __nv_bfloat16* kb = ks + (c - c_begin) % ST * (S::kStage / 2);
    cp_async_wait<ST - 2>();
    // Chunk c landed; chunk c - 1's stage, metadata slot and partial
    // scores are free.
    named_barrier(1 + team, TT);
    const Meta ahead = meta_load(c + ST);
    load_chunk(c + ST - 1);

    // This warp's partial scores of the chunk's 32 keys over its k-steps.
    float s_acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + k_ld + np * 16 * LD + s * 16);
        mma_16816(s_acc[2 * np], qa[s], b[0], b[1]);
        mma_16816(s_acc[2 * np + 1], qa[s], b[2], b[3]);
      }
    }
    meta_store(c + ST, ahead);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      sp[(warp * NT + n) * 32 + lane] = make_float4(s_acc[n][0], s_acc[n][1], s_acc[n][2],
                                                    s_acc[n][3]);
    named_barrier(1 + team, TT);  // the partial scores and chunk c + ST's metadata

    // The full scores, summed in warp order (the same in every warp),
    // scaled and masked; element e of tile n is row gid + 8 (e >> 1), key
    // 8 n + 2 tig + (e & 1).
    const unsigned vis = vis_s[slot];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float4 x = sp[n * 32 + lane];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const float4 y = sp[(w * NT + n) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      const bool v0 = (vis >> (8 * n + 2 * tig)) & 1u, v1 = (vis >> (8 * n + 2 * tig + 1)) & 1u;
      s_acc[n][0] = v0 ? x.x * scale : kNegInf;
      s_acc[n][1] = v1 ? x.y * scale : kNegInf;
      s_acc[n][2] = v0 ? x.z * scale : kNegInf;
      s_acc[n][3] = v1 ? x.w * scale : kNegInf;
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s_acc[n][2 * r], s_acc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
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
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o_acc[n][0] *= alpha[0];
      o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1];
      o_acc[n][3] *= alpha[1];
    }
    // O += P V on this warp's columns: the score tiles 2 kk and 2 kk + 1,
    // rounded to bf16, are the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1]);
      pa[1] = pack_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3]);
      pa[2] = pack_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]);
      pa[3] = pack_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kb + v_ld + kk * 16 * LD + j * 16);
        mma_16816(o_acc[2 * j], pa, b[0], b[1]);
        mma_16816(o_acc[2 * j + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  named_barrier(1 + team, TT);  // the team's stages are free

  // Team 1's state into team 0's: its O through its stages (float4 n of
  // team thread t at [n][t], the same fragment positions in both teams),
  // its m and l (the same in all its warps) beside.
  float4* ox = reinterpret_cast<float4*>(ks);
  if (team == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      ox[n * TT + ttid] = make_float4(o_acc[n][0], o_acc[n][1], o_acc[n][2], o_acc[n][3]);
    if (warp == 0 && tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ml_s[gid + 8 * r] = m_run[r];
        ml_s[R + gid + 8 * r] = l_run[r];
      }
    }
  }
  __syncthreads();
  if (team == 1) return;
  ox = reinterpret_cast<float4*>(smem + S::kQ + S::kTeam);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = ml_s[gid + 8 * r], l1 = ml_s[R + gid + 8 * r];
    const float m = fmaxf(m_run[r], m1);
    const float a0 = expf(m_run[r] - m), a1 = expf(m1 - m);
    l_run[r] = l_run[r] * a0 + l1 * a1;
    m_run[r] = m;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float4 y = ox[n * TT + ttid];
      o_acc[n][2 * r] = o_acc[n][2 * r] * a0 + (r ? y.z : y.x) * a1;
      o_acc[n][2 * r + 1] = o_acc[n][2 * r + 1] * a0 + (r ? y.w : y.y) * a1;
    }
  }

  // This thread's outputs: rows gid and gid + 8, columns warp D / 4 + 8 n +
  // 2 tig (+ 1) from o_acc[n][2 r + e]. m and l are the same in every warp.
  if (part_acc != nullptr) {
    if (warp == 0 && tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part_ml[gid + 8 * r] = m_run[r];
        part_ml[R + gid + 8 * r] = l_run[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* prow = part_acc + (gid + 8 * r) * D + warp * NO * 8 + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(prow + 8 * n) = make_float2(o_acc[n][2 * r], o_acc[n][2 * r + 1]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gid + 8 * r;
    if (row >= G) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = out + row * D + warp * NO * 8 + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o_acc[n][2 * r] * inv, o_acc[n][2 * r + 1] * inv);
  }
}

// Grid (batch, n_split): CTA (b, split) takes row b's split-th run of
// chunks; the row's last split folds its tail. With n_split > 1 each CTA
// writes its state to part_acc [B, n_split, 16, D] and part_ml [B, n_split,
// 2, 16] for latent_combine_kernel.
template <int D, int G, bool SHARED, bool TAIL>
__global__ void __launch_bounds__(kLatentDecodeThreads, kLatentDecodeCtasPerSm)
    latent_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, G, D]
                         const __nv_bfloat16* __restrict__ k,  // [P, 1, ps, D]
                         const __nv_bfloat16* __restrict__ v,  // as k; unread when SHARED
                         const int* __restrict__ page_table,   // [B, pps]
                         const int* __restrict__ ctx_lens,     // [B] paged keys to attend
                         const __nv_bfloat16* __restrict__ tail_k,  // [B, T, 1, D] or null
                         const __nv_bfloat16* __restrict__ tail_v,  // unread when SHARED
                         const int* __restrict__ tail_lens,         // [B] valid tail slots
                         __nv_bfloat16* __restrict__ out,           // [B, G, D]
                         float* __restrict__ part_acc, float* __restrict__ part_ml,
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
  latent_split_decode_tile<D, G, SHARED, TAIL>(
      q + row, out + row, k, v, page_table + static_cast<size_t>(b) * pages_per_seq,
      ctx + tail_len - 1, ctx, page_size, pages_per_seq, window, sinks, scale, smem_raw, split,
      n_split, to_parts ? part_acc + part * kLatentDecodeRows * D : nullptr,
      to_parts ? part_ml + part * 2 * kLatentDecodeRows : nullptr,
      fold ? tail_k + tail_row : nullptr, fold && !SHARED ? tail_v + tail_row : nullptr,
      fold ? min(tail_len, tail_slots) : 0);
}

// The combine pass of a split launch: CTA (part p, row g) merges the
// n_split states of row g of part p (merge_split_row). Part p = b * tiles +
// tile holds R rows, rows tile * R + g of sequence b's rows_per_seq output
// rows: the latent decode has one part a row (tiles 1, R = 16, rows_per_seq
// = G), the latent prefill one a 64-row tile (rows_per_seq = q_seq * G).
// The latent ragged kernel has its own pass (latent_ragged_combine_kernel).
template <int D, int R>
__global__ void __launch_bounds__(kCombineThreads<D>)
    latent_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          __nv_bfloat16* __restrict__ out, int n_split, int tiles,
                          int rows_per_seq) {
  const int p = blockIdx.x, g = blockIdx.y;
  const int b = p / tiles;
  const int row = (p - b * tiles) * R + g;
  if (row >= rows_per_seq) return;
  merge_split_row<D>(part_acc + (static_cast<size_t>(p) * n_split * R + g) * D,
                     static_cast<size_t>(R) * D,
                     part_ml + static_cast<size_t>(p) * n_split * 2 * R + g, 2 * R, R, n_split,
                     out + (static_cast<size_t>(b) * rows_per_seq + row) * D, threadIdx.x);
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
// heads (8 tokens x 8 for a tensor-parallel rank's half of them: half the
// operations of a chunk, the same tile), all sharing the single latent
// head, so each staged key serves 64 rows. The tile's queries are staged once, swizzled; each CK-key chunk of
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
constexpr int kLatentPrefillRows = 64;  // one wgmma M tile: 4 tokens x 16 heads, 8 x 8

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

// ---------------------------------------------------------------------------
// Ragged mixed prefill + decode over the shared latent. Replaces the
// shared_kv arm of _ragged_kernel (llmd_kv_cache_tpu/ops/pallas_paged_attention.py:736;
// the latent read as V at :900-905) with its decode-burst tail fold
// (has_tail, :829-838 and :936-956).
//
// One launch serves a flat token axis where row r's new tokens sit at flat
// slots [row_starts[r], row_starts[r+1]) at positions ctx_lens[r] + i, every
// token's latent already scattered into the pool, which is K and V. The TPU
// kernel walks the rows of each aligned q block in sequence; here each row
// goes to one of the two latent tiles above, by its length, as
// ragged_kernel in paged_attention.cu does for GQA:
//
// - Decode arm: a 1-token row (its 16 heads fill one m16 tile) is a
//   latent_split_decode_tile, its keys split across n_split CTAs. Bound:
//   bytes. A decode-only dispatch of 8 rows over 4160 latents is 38.3 MB,
//   0.0115 ms at 3.35 TB/s; the split fills the SMs with two-pipeline CTAs
//   that read each latent once (the latent decode's design and its note).
//   With TAIL, a row with tail_lens[r] > 0 keeps its new latent in the
//   dense tail: its paged keys are [0, ctx), its query sits at ctx +
//   tail_len - 1 and its last split folds the tail, as in the latent
//   decode.
// - Prefill arm: a longer row (2 tokens and up) is cut into 64-row wgmma
//   tiles of 4 tokens x 16 heads, each a latent_prefill_wg pair (its note:
//   each staged latent chunk feeds Q K^T and P V), and each tile's key
//   chunks are split across n_split_p CTAs, as the latent prefill splits a
//   short chunk: a 64-token chunk over 4096 cached latents is 16 tiles,
//   which unsplit would run on 16 of the 132 SMs, each walking all 4096
//   keys. Each warp finds its CTA's row and tile from row_starts itself
//   (ragged_tile in attention_common.cuh), the tiles taken last first, so
//   no launch builds a tile table first. Bound: operations. A mixed
//   dispatch (8 decode rows over 4160 latents + a 2048-token chunk over
//   2048 cached) is ~0.233 TFLOP, ~0.236 ms at 989 TFLOP/s, nearly all of
//   it the chunk's causal pairs, which these tiles run on wgmma. Rows'
//   tails are ignored here: a tail rides only a 1-token row (the JAX
//   contract).
//
// Both arms are 256-thread CTAs, one an SM, in one grid, so the wrapper
// plans their splits together, from shapes only (latent_ragged_splits):
// the prefill tiles and the decode rows share one wave of the SMs where
// they fit in one. Grid: ragged_tile_slots x n_split_p prefill CTAs (CTA x
// serves tile slot x / n_split_p, split x % n_split_p; surplus slots exit
// after helping zero the slots past row_starts[rows]), then rows x n_split
// decode CTAs (a CTA of a row that is not a decode row exits at once); the
// dynamic shared memory is the larger of the two tiles' layouts. With
// n_split > 1 or n_split_p > 1, latent_ragged_combine_kernel merges each
// decode row's and each prefill tile's splits into their flat slots (one
// launch, counted with the kernel's).
// ---------------------------------------------------------------------------

constexpr int kLatentRaggedDecodeTokens = 1;  // 16 heads fill the decode tile with one token

template <int D>
struct LatentRaggedSmem {
  static constexpr int kDecode = LatentDecodeSmem<D, true>::kBytes;
  static constexpr int kPrefill = LatentPrefillSmem<D>::kBytes;  // with the 1024-byte alignment
  static constexpr int kBytes = kDecode > kPrefill ? kDecode : kPrefill;
  static_assert(kBytes <= 232448, "one CTA's shared memory on an H100");
  static_assert(kLatentDecodeThreads == kLatentPrefillThreads && kLatentDecodeCtasPerSm == 1,
                "one CTA shape and one CTA an SM for both arms");
};

// The split states of a latent ragged launch, in its workspace: the decode
// arm's ([rows, n_split, 16, D] O, then [rows, n_split, 2, 16] m and l) when
// n_split > 1, then the prefill arm's ([slots, n_split_p, 64, D] O, then
// [slots, n_split_p, 2, 64] m and l) when n_split_p > 1.
struct LatentRaggedParts {
  float *dec_acc = nullptr, *dec_ml = nullptr, *pre_acc = nullptr, *pre_ml = nullptr;
};

inline size_t latent_ragged_floats(int rows, int slots, int head_dim, int n_split, int n_split_p,
                                   size_t* decode_floats) {
  *decode_floats = n_split > 1 ? static_cast<size_t>(rows) * n_split * kLatentDecodeRows *
                                     (head_dim + 2)
                               : 0;
  return *decode_floats + (n_split_p > 1 ? static_cast<size_t>(slots) * n_split_p *
                                               kLatentPrefillRows * (head_dim + 2)
                                         : 0);
}

inline LatentRaggedParts latent_ragged_parts(void* workspace, int rows, int slots, int head_dim,
                                             int n_split, int n_split_p) {
  LatentRaggedParts parts;
  float* ws = static_cast<float*>(workspace);
  if (ws == nullptr) return parts;
  size_t dec;
  latent_ragged_floats(rows, slots, head_dim, n_split, n_split_p, &dec);
  if (n_split > 1) {
    parts.dec_acc = ws;
    parts.dec_ml = ws + static_cast<size_t>(rows) * n_split * kLatentDecodeRows * head_dim;
  }
  if (n_split_p > 1) {
    parts.pre_acc = ws + dec;
    parts.pre_ml = parts.pre_acc +
                   static_cast<size_t>(slots) * n_split_p * kLatentPrefillRows * head_dim;
  }
  return parts;
}

template <int D, int G, bool TAIL>
__global__ void __launch_bounds__(kLatentDecodeThreads, 1)
    latent_ragged_kernel(const __nv_bfloat16* __restrict__ q,  // [total_q, G, D]
                         const __nv_bfloat16* __restrict__ k,  // [P, 1, ps, D], also V
                         const int* __restrict__ page_table,   // [rows, pps]
                         const int* __restrict__ row_starts,   // [rows + 1] flat prefix sums
                         const int* __restrict__ ctx_lens,     // [rows] cached before the new
                         const __nv_bfloat16* __restrict__ tail_k,  // [rows, T, 1, D] or null
                         const int* __restrict__ tail_lens,         // [rows] valid tail slots
                         __nv_bfloat16* __restrict__ out,           // [total_q, G, D]
                         LatentRaggedParts parts, int total_q, int rows, int n_prefill,
                         int n_split, int n_split_p, int page_size, int pages_per_seq,
                         int tail_slots, int window, int sinks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = kLatentDecodeRows, QT = kLatentPrefillRows / G;

  if (static_cast<int>(blockIdx.x) >= n_prefill) {  // the decode arm
    const int x = blockIdx.x - n_prefill;
    const int r = x / n_split, split = x - r * n_split;
    // Clamped to the flat axis, so a malformed row_starts cannot reach past q.
    const int start = min(max(row_starts[r], 0), total_q);
    if (min(max(row_starts[r + 1], start), total_q) - start != kLatentRaggedDecodeTokens) return;
    const int ctx = ctx_lens[r];
    const int tail_len = TAIL ? max(tail_lens[r], 0) : 0;
    const bool fold = tail_len > 0 && split == n_split - 1;
    const size_t off = static_cast<size_t>(start) * G * D;
    const size_t part = static_cast<size_t>(r) * n_split + split;
    latent_split_decode_tile<D, G, true, TAIL>(
        q + off, out + off, k, k, page_table + static_cast<size_t>(r) * pages_per_seq,
        tail_len > 0 ? ctx + tail_len - 1 : ctx, tail_len > 0 ? ctx : ctx + 1, page_size,
        pages_per_seq, window, sinks, scale, smem_raw, split, n_split,
        n_split > 1 ? parts.dec_acc + part * R * D : nullptr,
        n_split > 1 ? parts.dec_ml + part * 2 * R : nullptr,
        fold ? tail_k + static_cast<size_t>(r) * tail_slots * D : nullptr, nullptr,
        fold ? min(tail_len, tail_slots) : 0);
    return;
  }

  // The prefill arm: CTA x serves split x % n_split_p of tile slot x /
  // n_split_p (the splits of a tile adjacent, the last tiles first).
  unsigned char* smem = align_1024(smem_raw);
  const int x = blockIdx.x;
  const int slot = x / n_split_p, split = x - slot * n_split_p;
  // Flat slots past the last row hold no token: zeros.
  const int real = min(max(row_starts[rows], 0), total_q);
  for (int j = real + x; j < total_q; j += n_prefill) {
    __nv_bfloat16* o = out + static_cast<size_t>(j) * G * D;
    for (int i = threadIdx.x; i < G * D; i += kLatentPrefillThreads)
      o[i] = __float2bfloat16_rn(0.f);
  }
  // Row and tile, clamped to the flat axis like the decode arm's.
  const RaggedTile tile = ragged_tile(row_starts, rows, total_q, QT, kLatentRaggedDecodeTokens,
                                      slot);
  if (tile.row < 0) return;
  const int r = tile.row, ctx = ctx_lens[r];
  const size_t off = static_cast<size_t>(tile.start) * G * D;
  const int* table = page_table + static_cast<size_t>(r) * pages_per_seq;
  // Part x of the prefill states: [slot][split].
  float* acc = n_split_p > 1 ? parts.pre_acc + static_cast<size_t>(x) * kLatentPrefillRows * D
                             : nullptr;
  float* ml = n_split_p > 1 ? parts.pre_ml + static_cast<size_t>(x) * 2 * kLatentPrefillRows
                            : nullptr;
  using S = LatentPrefillSmem<D>;
  if (threadIdx.x < 128)
    latent_prefill_wg<D, G, S::NB0, true>(q + off, out + off, k, table, tile.len, tile.t0, ctx,
                                          ctx + tile.len, page_size, pages_per_seq, window,
                                          sinks, scale, smem, split, n_split_p, acc, ml);
  else
    latent_prefill_wg<D, G, S::NB - S::NB0, false>(q + off, out + off, k, table, tile.len,
                                                   tile.t0, ctx, ctx + tile.len, page_size,
                                                   pages_per_seq, window, sinks, scale, smem,
                                                   split, n_split_p, acc, ml);
}

// The combine pass of a split latent ragged launch, one CTA a merged row
// (merge_split_row): first n_dec CTAs for the decode arm's states (CTA r x
// 16 + g: head g of row r, merged into flat slot row_starts[r] when row r
// took the decode arm), then the prefill arm's (CTA s x 64 + i: tile row i
// of tile slot s, found by ragged_tile as the kernel found it, is head i %
// G of token t0 + i / G of its row, merged into that token's flat slot;
// rows past the row's tokens are skipped). An arm that ran unsplit has no
// CTA here.
template <int D, int G>
__global__ void __launch_bounds__(kCombineThreads<D>)
    latent_ragged_combine_kernel(LatentRaggedParts parts, const int* __restrict__ row_starts,
                                 __nv_bfloat16* __restrict__ out, int total_q, int rows,
                                 int n_dec, int n_split, int n_split_p) {
  constexpr int R = kLatentDecodeRows, P = kLatentPrefillRows;
  int x = blockIdx.x;
  if (x < n_dec) {
    const int r = x / R, g = x - r * R;
    const int start = min(max(row_starts[r], 0), total_q);
    if (min(max(row_starts[r + 1], start), total_q) - start != kLatentRaggedDecodeTokens) return;
    merge_split_row<D>(parts.dec_acc + (static_cast<size_t>(r) * n_split * R + g) * D,
                       static_cast<size_t>(R) * D,
                       parts.dec_ml + static_cast<size_t>(r) * n_split * 2 * R + g, 2 * R, R,
                       n_split, out + (static_cast<size_t>(start) * G + g) * D, threadIdx.x);
    return;
  }
  x -= n_dec;
  const int slot = x / P, i = x - slot * P;
  const RaggedTile tile =
      ragged_tile(row_starts, rows, total_q, P / G, kLatentRaggedDecodeTokens, slot);
  const int tok = tile.t0 + i / G;
  if (tile.row < 0 || tok >= tile.len) return;
  merge_split_row<D>(parts.pre_acc + (static_cast<size_t>(slot) * n_split_p * P + i) * D,
                     static_cast<size_t>(P) * D,
                     parts.pre_ml + static_cast<size_t>(slot) * n_split_p * 2 * P + i, 2 * P, P,
                     n_split_p, out + ((static_cast<size_t>(tile.start) + tok) * G + i % G) * D,
                     threadIdx.x);
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
  constexpr int smem = LatentDecodeSmem<D, SHARED>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(latent_decode_kernel<D, G, SHARED, TAIL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml =
      part_acc == nullptr ? nullptr
                          : part_acc + static_cast<size_t>(batch) * n_split * kLatentDecodeRows * D;
  latent_decode_kernel<D, G, SHARED, TAIL>
      <<<dim3(batch, n_split), kLatentDecodeThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), table, ctx_lens,
      static_cast<const __nv_bfloat16*>(tail_k), static_cast<const __nv_bfloat16*>(tail_v),
      tail_lens, static_cast<__nv_bfloat16*>(out), part_acc, part_ml, page_size,
      pages_per_seq, tail_slots, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  latent_combine_kernel<D, kLatentDecodeRows>
      <<<dim3(batch, G), kCombineThreads<D>, 0, stream>>>(
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
      <<<dim3(batch * n_tiles, kLatentPrefillRows), kCombineThreads<D>, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), n_split, n_tiles, q_seq * G);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G, bool TAIL>
int launch_latent_ragged_kernels(const void* q, const void* k, const int* table,
                                 const int* row_starts, const int* ctx_lens, const void* tail_k,
                                 const int* tail_lens, void* out, int total_q, int rows,
                                 int page_size, int pages_per_seq, int tail_slots, int window,
                                 int sinks, float scale, int n_split, int n_split_p,
                                 void* workspace, cudaStream_t stream) {
  constexpr int smem = LatentRaggedSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      latent_ragged_kernel<D, G, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int slots =
      ragged_tile_slots(total_q, rows, kLatentPrefillRows / G, kLatentRaggedDecodeTokens);
  const LatentRaggedParts parts =
      latent_ragged_parts(workspace, rows, slots, D, n_split, n_split_p);
  const int n_prefill = slots * n_split_p;
  latent_ragged_kernel<D, G, TAIL>
      <<<n_prefill + rows * n_split, kLatentDecodeThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), table,
      row_starts, ctx_lens, static_cast<const __nv_bfloat16*>(tail_k), tail_lens,
      static_cast<__nv_bfloat16*>(out), parts, total_q, rows, n_prefill, n_split, n_split_p,
      page_size, pages_per_seq, tail_slots, window, sinks, scale);
  cudaError_t err = cudaGetLastError();
  const int n_dec = n_split > 1 ? rows * kLatentDecodeRows : 0;
  const int n_pre = n_split_p > 1 ? slots * kLatentPrefillRows : 0;
  if (err != cudaSuccess || n_dec + n_pre == 0) return static_cast<int>(err);
  latent_ragged_combine_kernel<D, G><<<n_dec + n_pre, kCombineThreads<D>, 0, stream>>>(
      parts, row_starts, static_cast<__nv_bfloat16*>(out), total_q, rows, n_dec, n_split,
      n_split_p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G>
int launch_latent_ragged(const void* q, const void* k, const int* table, const int* row_starts,
                         const int* ctx_lens, const void* tail_k, const int* tail_lens,
                         void* out, int total_q, int rows, int page_size, int pages_per_seq,
                         int tail_slots, int window, int sinks, float scale, int n_split,
                         int n_split_p, void* workspace, cudaStream_t stream) {
  return tail_k != nullptr
             ? launch_latent_ragged_kernels<D, G, true>(
                   q, k, table, row_starts, ctx_lens, tail_k, tail_lens, out, total_q, rows,
                   page_size, pages_per_seq, tail_slots, window, sinks, scale, n_split,
                   n_split_p, workspace, stream)
             : launch_latent_ragged_kernels<D, G, false>(
                   q, k, table, row_starts, ctx_lens, tail_k, tail_lens, out, total_q, rows,
                   page_size, pages_per_seq, tail_slots, window, sinks, scale, n_split,
                   n_split_p, workspace, stream);
}

}  // namespace

extern "C" {

// Keys a split CTA of the latent decode takes at a time: the caller sizes
// n_split with it (a split of fewer chunks than one would stream nothing).
int llmd_latent_decode_chunk_keys() { return kLatentDecodeChunk; }

// CTAs of the latent decode an SM holds at once: the caller plans n_split
// to fill sm_count times as many CTA slots once.
int llmd_latent_decode_ctas_per_sm() { return kLatentDecodeCtasPerSm; }

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
// 640 with 16 query heads (absorbed MLA) or 8 (a tensor-parallel rank's
// half of them); separate V at head_dim 128 with 8 or 16 query heads (MQA). window < 0: no sliding window. Returns 0 when
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
                            tail_slots < 1 || tail_slots > kLatentDecodeTailSlots))
    return -1;
  if (shared_kv && q_heads == 16 && head_dim == 576)
    return launch_latent_decode<576, 16, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
                                               batch, page_size, pages_per_seq, tail_slots,
                                               window, sinks, scale, n_split, workspace, s);
  if (shared_kv && q_heads == 16 && head_dim == 640)
    return launch_latent_decode<640, 16, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
                                               batch, page_size, pages_per_seq, tail_slots,
                                               window, sinks, scale, n_split, workspace, s);
  // A tensor-parallel rank's local heads of the replicated latent: 16 / tp.
  if (shared_kv && q_heads == 8 && head_dim == 576)
    return launch_latent_decode<576, 8, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
                                              batch, page_size, pages_per_seq, tail_slots,
                                              window, sinks, scale, n_split, workspace, s);
  if (shared_kv && q_heads == 8 && head_dim == 640)
    return launch_latent_decode<640, 8, true>(q, k, k, table, ctx, tail_k, tail_k, tl, out,
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

// Tokens a latent prefill tile takes at q_heads query heads a token (4 at
// 16 heads, 8 at 8; 0 for an unbuilt head count), the keys a chunk at this
// width (0 for an unbuilt width) and the bytes of fp32 workspace a launch
// of n_split > 1 needs (0 for n_split == 1): the caller plans the split
// from these.
int llmd_latent_prefill_tile_tokens(int q_heads) {
  return q_heads == 8 || q_heads == 16 ? kLatentPrefillRows / q_heads : 0;
}
int llmd_latent_prefill_chunk_keys(int head_dim) {
  if (head_dim == 576) return LatentPrefillSmem<576>::CK;
  if (head_dim == 640) return LatentPrefillSmem<640>::CK;
  return 0;
}
long long llmd_latent_prefill_workspace_bytes(int batch, int q_seq, int q_heads, int head_dim,
                                             int n_split) {
  const int tile_tokens = llmd_latent_prefill_tile_tokens(q_heads);
  if (n_split <= 1 || tile_tokens == 0) return 0;
  const long long tiles = (q_seq + tile_tokens - 1) / tile_tokens;
  return static_cast<long long>(batch) * tiles * n_split * kLatentPrefillRows * (head_dim + 2) * 4;
}

// q [batch, q_seq, q_heads, head_dim] bf16 (query i at ctx_len + i); k the
// latent pool [pages, 1, page_size, head_dim] bf16 with the new tokens'
// latents already scattered (it is also V); ctx_lens, total_lens [batch]
// i32; out like q. Each tile's key chunks are split across n_split CTAs (1
// = no split, no combine pass); workspace holds
// llmd_latent_prefill_workspace_bytes. Built: head_dim 576 or 640 with 16
// query heads, or 8 (a tensor-parallel rank's). Returns 0 when the kernels
// launched.
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
  // A tensor-parallel rank's 8 local heads: a tile is 8 tokens x 8 heads.
  if (q_heads == 8 && head_dim == 576)
    return launch_latent_prefill<576, 8>(q, k, table, ctx, total, out, batch, q_seq, page_size,
                                         pages_per_seq, window, sinks, scale, n_split,
                                         workspace, s);
  if (q_heads == 8 && head_dim == 640)
    return launch_latent_prefill<640, 8>(q, k, table, ctx, total, out, batch, q_seq, page_size,
                                         pages_per_seq, window, sinks, scale, n_split,
                                         workspace, s);
  return -1;
}

// Bytes of fp32 workspace a latent ragged launch needs: the split states
// of its decode arm (n_split > 1) and of its prefill arm (n_split_p > 1);
// 0 when neither splits.
long long llmd_latent_ragged_workspace_bytes(int total_q, int rows, int head_dim, int n_split,
                                             int n_split_p) {
  const int slots = ragged_tile_slots(total_q, rows, kLatentPrefillRows / 16,
                                      kLatentRaggedDecodeTokens);
  size_t dec;
  return static_cast<long long>(
      latent_ragged_floats(rows, slots, head_dim, n_split, n_split_p, &dec) * 4);
}

// q [total_q, q_heads, head_dim] bf16, row r's tokens at flat slots
// [row_starts[r], row_starts[r+1]) at positions ctx_lens[r] + i, their
// latents already scattered into k, the latent pool [pages, 1, page_size,
// head_dim] bf16 (also V); page_table [rows, pages_per_seq], row_starts
// [rows + 1] and ctx_lens [rows] i32. A 1-token row takes the decode arm, a
// longer one ceil(len / llmd_latent_prefill_tile_tokens()) prefill tiles,
// which the kernel finds from row_starts. The decode-burst tail: tail_k
// [rows, tail_slots, 1, head_dim] bf16 and tail_lens [rows] i32, 1 <=
// tail_slots <= 64, or tail_k null (no tail); only 1-token rows fold
// theirs. Each decode row's keys are split across n_split CTAs and each
// prefill tile's across n_split_p (1 = no split; a combine pass runs when
// either is above 1); workspace holds llmd_latent_ragged_workspace_bytes.
// out like q, zeros past row_starts[rows]. Built: head_dim 576 or 640 with
// 16 query heads. Returns 0 when the kernels launched.
int llmd_latent_ragged_bf16(const void* q, const void* k, const void* page_table,
                            const void* row_starts, const void* ctx_lens, const void* tail_k,
                            const void* tail_lens, void* out, int total_q, int rows,
                            int q_heads, int head_dim, int page_size, int pages_per_seq,
                            int tail_slots, int window, int sinks, float scale, int n_split,
                            int n_split_p, void* workspace, void* stream) {
  const int* table = static_cast<const int*>(page_table);
  const int* starts = static_cast<const int*>(row_starts);
  const int* ctx = static_cast<const int*>(ctx_lens);
  const int* tl = static_cast<const int*>(tail_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || total_q < 0 || n_split <= 0 || n_split_p <= 0 ||
      ((n_split > 1 || n_split_p > 1) && workspace == nullptr))
    return -1;
  if (tail_k != nullptr &&
      (tail_lens == nullptr || tail_slots < 1 || tail_slots > kLatentDecodeTailSlots))
    return -1;
  if (q_heads == 16 && head_dim == 576)
    return launch_latent_ragged<576, 16>(q, k, table, starts, ctx, tail_k, tl, out, total_q,
                                         rows, page_size, pages_per_seq, tail_slots, window,
                                         sinks, scale, n_split, n_split_p, workspace, s);
  if (q_heads == 16 && head_dim == 640)
    return launch_latent_ragged<640, 16>(q, k, table, starts, ctx, tail_k, tl, out, total_q,
                                         rows, page_size, pages_per_seq, tail_slots, window,
                                         sinks, scale, n_split, n_split_p, workspace, s);
  return -1;
}

}  // extern "C"
