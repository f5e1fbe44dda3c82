// The bookkeeping of a beam iteration, one query a block, in shared memory
// (ops/beam_step.py).
//
// Replaces no TPU kernel: the JAX package does this bookkeeping with jnp
// sorts and compares (hnsw_tpu/ops/beam_search.py). The port did it with
// torch.sort and torch.searchsorted, a dozen library sorts an iteration over
// data of a few KB a query: the selection (a sort of the beam), the revisit
// tests (the ring sorted twice and the beam once, then searchsorted), the
// intra-step duplicates (a sort of the candidates' ids) and the merge (a
// key-value sort of beam and candidates). At the serving shape (ef 128, E 4,
// M0 96, B 10,000) those sorts were half of the search's device time, some
// 60 times the bytes' bound.
//
// Bound on the H100: bytes. An iteration reads, per query, the beam (W ids
// and distances), the ring (H ids), the K candidates' ids (from the table)
// and scores, and writes K ids, W ids and distances and E ring entries: under
// 8 KB a query at the serving shape, about 25 us for B = 10,000 at 3.35 TB/s.
// The work per query is small and serial in parts (a few block barriers), so
// the kernels hide latency with many resident blocks: one block a query,
// 128-512 threads by K, shared memory sized from the shapes.
//
// Contract (the plain versions, ops/beam_step.py, are the reference; every
// output is a copy or a comparison of an input, so the two agree bit for bit):
//
// beam_select_kernel, for query b:
//   select: an entry of the beam (beam_ids, beam_d [B, W], ascending) is
//     expanded when its id is in the ring hist [B, H]. The E entries
//     selected are smallest(where(expanded | id < 0, INF, beam_d), E) under
//     torch.sort's stable order, NaN last. step_done = done | nearest == INF
//     | nearest > thresh, thresh = worst (slack_one) or, for a finite worst,
//     worst + slack_m1 * |worst| in two rounded f32 operations (no FMA: torch
//     computes it in two kernels). sel_ok = !step_done & sel_d < INF; ring
//     slot [slot, slot + E) := sel_ok ? id : -2; src_out [B, E] := the
//     selected ids clamped into [0, cap1 - 1] (0 for a query already done);
//     done_out[b] := step_done.
//   suppress: candidate c = e * M + m is the m-th neighbour of selected
//     entry e, tbl[src_e * ld + m], valid when sel_ok[e] and its id >= 0; it
//     is kept when valid, its id is in neither the beam nor the ring (after
//     the write), and no lower valid position holds the same id. new_ids
//     [B, K] := kept ? id : -1.
// beam_merge_kernel: the first ef of the stable ascending order of the
//   concatenation [beam (W, ascending) | candidates (K)] by distance, NaN
//   last: out_ids, out_d [B, ef].
//
// Design.
//   Select and suppress share one open-addressing hash table of (id, value)
//   in shared memory (2^log_t slots, at most 5/6 full): the ring outside
//   the slot this iteration overwrites goes in with value -2 and the beam
//   with -1, so a beam entry is expanded when its value is -2 or its id is
//   one of the old slot's E entries (a linear test), which keeps the ring's
//   wrap-around exact; the new slot's ids are all beam ids, so after the
//   write "in the beam or the ring" is "in the table". Each valid candidate
//   then takes atomicMin(value, c): it is kept when the value it finds
//   afterwards is its own position (-1 and -2 block it; the lowest position
//   wins). The selection is E block-wide minimum reductions over the
//   64-bit keys (orderable distance bits, position), the stable sort's
//   order. A query already done writes its -2 ring entries and -1
//   candidates and leaves.
//   The merge ranks instead of sorting. A candidate whose distance is at or
//   above the beam's ef-th lands at ef or later, so only the finite ones
//   below it are kept (after suppression most candidates are -1/INF, and
//   after the first iterations few of the rest beat the beam): compacted and
//   put in order by a bitonic network over their keys (orderable distance
//   bits, position) in shared memory. Beam entry i lands at i + #candidates
//   below it, kept candidate j (in order) at j + #beam entries at or below
//   it, by binary search. The beam is ascending: a merge made it, or
//   beam_setup put the start entries in stable order. +INF candidates follow
//   the beam's +INF entries, NaNs come last, each class in position order (a
//   block scan, only when the output reaches them).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int MAX_WARPS = 16;     // 512 threads
constexpr int EMPTY = -1;         // a free hash slot (only ids >= 0 go in)
constexpr uint32_t ORD_INF = 0xFF800000u;
constexpr uint32_t ORD_NAN = 0xFFFFFFFFu;

// Orderable bits: a < b as floats (any NaN above +INF, -0 below +0, as the
// card's radix sort orders them) iff ord(a) < ord(b) as integers.
__device__ __forceinline__ uint32_t ord(float v) {
  if (v != v) return ORD_NAN;
  const uint32_t x = __float_as_uint(v);
  return (x & 0x80000000u) ? ~x : (x | 0x80000000u);
}

__device__ __forceinline__ float unord(uint32_t o) {
  if (o == ORD_NAN) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ int hash_slot(int id, int shift) {
  return (int)(((uint32_t)id * 2654435761u) >> shift);
}

// The slot of `id` (inserted if absent), its value lowered to `v`.
__device__ int table_insert(int* keys, int* vals, int mask, int shift, int id, int v) {
  int s = hash_slot(id, shift);
  while (true) {
    const int prev = atomicCAS(&keys[s], EMPTY, id);
    if (prev == EMPTY || prev == id) {
      atomicMin(&vals[s], v);
      return s;
    }
    s = (s + 1) & mask;
  }
}

// The slot of `id`, or -1 (no insert in flight).
__device__ int table_find(const int* keys, int mask, int shift, int id) {
  int s = hash_slot(id, shift);
  while (true) {
    const int k = keys[s];
    if (k == id) return s;
    if (k == EMPTY) return -1;
    s = (s + 1) & mask;
  }
}

__device__ __forceinline__ u64 warp_min(u64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__global__ void beam_select_kernel(const int* __restrict__ beam_ids,
                                   const float* __restrict__ beam_d, int W,
                                   int* __restrict__ hist, int H, int slot, int E,
                                   const bool* __restrict__ done, bool* __restrict__ done_out,
                                   int* __restrict__ src_out, float slack_m1, int slack_one,
                                   int cap1, const int* __restrict__ tbl, long long ld, int M,
                                   int* __restrict__ new_ids, int K, int log_t) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int T = 1 << log_t, mask = T - 1, shift = 32 - log_t;

  extern __shared__ u64 smem[];
  u64* skeys = smem;                               // [W] selection keys
  int* keys = reinterpret_cast<int*>(smem + W);    // [T]
  int* vals = keys + T;                            // [T]
  int* cslot = vals + T;                           // [K]
  int* old_slot = cslot + K;                       // [E]
  int* sel_src = old_slot + E;                     // [E]
  int* sel_ok = sel_src + E;                       // [E]
  __shared__ u64 red[2][MAX_WARPS];

  const int* bids = beam_ids + (size_t)b * W;
  const float* bd = beam_d + (size_t)b * W;
  int* ring = hist + (size_t)b * H;
  int* out = new_ids + (size_t)b * K;

  if (done[b]) {  // nothing to select or to keep
    if (tid < E) {
      ring[slot + tid] = -2;
      src_out[(size_t)b * E + tid] = 0;
    }
    if (tid == 0) done_out[b] = true;
    for (int c = tid; c < K; c += nt) out[c] = -1;
    return;
  }

  for (int i = tid; i < T; i += nt) {
    keys[i] = EMPTY;
    vals[i] = INT_MAX;
  }
  if (tid < E) old_slot[tid] = ring[slot + tid];
  __syncthreads();
  for (int h = tid; h < H; h += nt) {
    if (h - slot >= 0 && h - slot < E) continue;
    const int id = ring[h];
    if (id >= 0) table_insert(keys, vals, mask, shift, id, -2);
  }
  for (int i = tid; i < W; i += nt) {
    const int id = bids[i];
    if (id >= 0) table_insert(keys, vals, mask, shift, id, -1);
  }
  __syncthreads();

  for (int i = tid; i < W; i += nt) {
    const int id = bids[i];
    bool expanded = false;
    if (id >= 0) {
      const int s = table_find(keys, mask, shift, id);
      expanded = s >= 0 && vals[s] == -2;
      for (int e = 0; e < E; ++e) expanded = expanded || old_slot[e] == id;
    }
    const float c = (expanded || id < 0) ? INFINITY : bd[i];
    skeys[i] = ((u64)ord(c) << 32) | (uint32_t)i;
  }
  __syncthreads();
  // E rounds of a block-wide minimum: the selection in stable order
  u64 prev = 0, first = 0, mine = 0;
  for (int r = 0; r < E; ++r) {
    u64 m = ~0ull;
    for (int i = tid; i < W; i += nt) {
      const u64 k = skeys[i];
      if ((r == 0 || k > prev) && k < m) m = k;
    }
    m = warp_min(m);
    if (lane == 0) red[r & 1][warp] = m;
    __syncthreads();
    m = ~0ull;
    for (int w = 0; w < nwarps; ++w) m = red[r & 1][w] < m ? red[r & 1][w] : m;
    prev = m;
    if (r == 0) first = m;
    if (tid == r) mine = m;
  }
  const float nearest = unord((uint32_t)(first >> 32));
  const float worst = bd[W - 1];
  float thresh = worst;
  if (!slack_one)
    thresh = isfinite(worst) ? __fadd_rn(worst, __fmul_rn(slack_m1, fabsf(worst))) : INFINITY;
  const bool step_done = nearest == INFINITY || nearest > thresh;
  if (tid < E) {
    const int pos = (int)(uint32_t)mine;
    const bool ok = !step_done && unord((uint32_t)(mine >> 32)) < INFINITY;
    const int src = bids[pos];
    const int src_c = min(max(src, 0), cap1 - 1);
    ring[slot + tid] = ok ? src : -2;
    src_out[(size_t)b * E + tid] = src_c;
    sel_ok[tid] = ok;
    sel_src[tid] = src_c;
  }
  if (tid == 0) done_out[b] = step_done;
  if (step_done) {  // the same on every thread
    for (int c = tid; c < K; c += nt) out[c] = -1;
    return;
  }
  __syncthreads();

  // suppression: every valid candidate lowers its id's value to its position
  for (int c = tid; c < K; c += nt) {
    const int e = c / M;
    int s = -1;
    if (sel_ok[e]) {
      const int id = tbl[(size_t)sel_src[e] * ld + (c - e * M)];
      if (id >= 0) s = table_insert(keys, vals, mask, shift, id, c);
    }
    cslot[c] = s;
  }
  __syncthreads();
  for (int c = tid; c < K; c += nt) {
    const int s = cslot[c];
    out[c] = (s >= 0 && vals[s] == c) ? keys[s] : -1;
  }
}

// #{j < n : (keys[j] >> 32) < o}, keys ascending
__device__ __forceinline__ int count_below(const u64* keys, int n, uint32_t o) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((uint32_t)(keys[mid] >> 32) < o) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{j < n : a[j] <= o}, a ascending
__device__ __forceinline__ int count_at_or_below(const uint32_t* a, int n, uint32_t o) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= o) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void beam_merge_kernel(const int* __restrict__ beam_ids,
                                  const float* __restrict__ beam_d, int W,
                                  const int* __restrict__ cand_ids,
                                  const float* __restrict__ cand_d, int K, int ef, int n_pad,
                                  int* __restrict__ out_ids, float* __restrict__ out_d) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const unsigned below = (1u << lane) - 1u;

  extern __shared__ u64 smem[];
  u64* fk = smem;                                         // [n_pad] kept candidates
  uint32_t* bs = reinterpret_cast<uint32_t*>(smem + n_pad);  // [W] beam, orderable bits
  __shared__ int count[3];                                // kept, +INF, NaN candidates
  __shared__ int wsum[MAX_WARPS];

  const int* bi = beam_ids + (size_t)b * W;
  const float* bdd = beam_d + (size_t)b * W;
  const int* ci = cand_ids + (size_t)b * K;
  const float* cdd = cand_d + (size_t)b * K;
  int* oi = out_ids + (size_t)b * ef;
  float* od = out_d + (size_t)b * ef;

  if (tid < 3) count[tid] = 0;
  for (int i = tid; i < W; i += nt) bs[i] = ord(bdd[i]);
  __syncthreads();
  // A candidate at or above the beam's ef-th entry lands at ef or later, so
  // only the finite ones below it are kept and put in order (after the first
  // iterations, a few a query); they are compacted a warp's in one atomic.
  const uint32_t cut = ef <= W ? min(bs[ef - 1], ORD_INF) : ORD_INF;
  for (int c0 = 0; c0 < K; c0 += nt) {
    const int c = c0 + tid;
    const uint32_t o = c < K ? ord(cdd[c]) : 0u;
    const unsigned keep = __ballot_sync(0xffffffffu, c < K && o < cut);
    const unsigned inf = __ballot_sync(0xffffffffu, c < K && o == ORD_INF);
    const unsigned nan = __ballot_sync(0xffffffffu, c < K && o == ORD_NAN);
    int base = 0;
    if (lane == 0) {
      if (keep) base = atomicAdd(&count[0], __popc(keep));
      if (inf) atomicAdd(&count[1], __popc(inf));
      if (nan) atomicAdd(&count[2], __popc(nan));
    }
    base = __shfl_sync(0xffffffffu, base, 0);
    if ((keep >> lane) & 1u) fk[base + __popc(keep & below)] = ((u64)o << 32) | (uint32_t)c;
  }
  __syncthreads();
  const int nf = count[0], ni = count[1], nn = count[2];
  int n = 1;
  while (n < nf) n <<= 1;
  for (int j = nf + tid; j < n; j += nt) fk[j] = ~0ull;
  __syncthreads();
  // bitonic network over the n keys, n / 2 compare-exchanges a stage
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (n >> 1); p += nt) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const u64 a = fk[i], c = fk[l];
        if ((a > c) == ((i & k) == 0)) {
          fk[i] = c;
          fk[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < W; i += nt) {
    const uint32_t o = bs[i];
    const int p = i + count_below(fk, nf, o) + (o == ORD_NAN ? ni : 0);
    if (p < ef) {
      oi[p] = bi[i];
      od[p] = bdd[i];
    }
  }
  for (int j = tid; j < nf && j < ef; j += nt) {
    const u64 key = fk[j];
    const int c = (int)(uint32_t)key;
    const int p = j + count_at_or_below(bs, W, (uint32_t)(key >> 32));
    if (p < ef) {
      oi[p] = ci[c];
      od[p] = cdd[c];
    }
  }
  // +INF candidates after the beam's +INF entries, then NaN ones after the
  // whole beam, each in position order (reached only by a short output)
  for (int cls = 0; cls < 2; ++cls) {
    const uint32_t want = cls == 0 ? ORD_INF : ORD_NAN;
    const int base = cls == 0 ? nf + count_at_or_below(bs, W, ORD_INF) : nf + ni + W;
    if ((cls == 0 ? ni : nn) == 0 || base >= ef) continue;
    int run = 0;
    for (int c0 = 0; c0 < K && base + run < ef; c0 += nt) {
      const int c = c0 + tid;
      const bool f = c < K && ord(cdd[c]) == want;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (lane == 0) wsum[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < nwarps; ++w) {
        before += w < warp ? wsum[w] : 0;
        total += wsum[w];
      }
      const int p = base + run + before + __popc(bal & below);
      if (f && p < ef) {
        oi[p] = ci[c];
        od[p] = cdd[c];
      }
      run += total;
      __syncthreads();
    }
  }
}

// Dynamic shared memory past 48 KB has to be asked for.
int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

// Shared memory of a launch (ops/beam_step.py::select_plan and merge_plan
// mirror it).
extern "C" long long beam_step_smem(int W, int K, int E, int log_t) {
  return 8LL * W + 8LL * (1LL << log_t) + 4LL * K + 12LL * E;
}

extern "C" long long beam_step_merge_smem(int W, int n_pad) { return 8LL * n_pad + 4LL * W; }

// threads a multiple of 32 up to 512, log_t the hash table's size. Arguments
// outside the contract return cudaErrorInvalidValue and launch nothing.
extern "C" int beam_step_launch(const void* beam_ids, const void* beam_d, int B, int W,
                                void* hist, int H, int slot, int E, const void* done,
                                void* done_out, void* src_out, float slack_m1, int slack_one,
                                int cap1, const void* tbl, long long ld, int M, void* new_ids,
                                int K, int threads, int log_t, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || E < 1 || E > W || E > threads || H < E || slot < 0 || slot + E > H ||
      cap1 < 1 || M < 1 || K != E * M || threads < 32 || threads > 32 * MAX_WARPS ||
      threads % 32 || log_t < 1 || log_t > 20)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)beam_step_smem(W, K, E, log_t);
  if (int rc = allow_smem((const void*)beam_select_kernel, smem)) return rc;
  beam_select_kernel<<<B, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int*)beam_ids, (const float*)beam_d, W, (int*)hist, H, slot, E,
      (const bool*)done, (bool*)done_out, (int*)src_out, slack_m1, slack_one, cap1,
      (const int*)tbl, ld, M, (int*)new_ids, K, log_t);
  return (int)cudaGetLastError();
}

extern "C" int beam_step_merge_launch(const void* beam_ids, const void* beam_d, int B, int W,
                                      const void* cand_ids, const void* cand_d, int K, int ef,
                                      int threads, int n_pad, void* out_ids, void* out_d,
                                      void* stream) {
  if (B == 0) return 0;
  if (W < 1 || K < 1 || ef < 1 || ef > W + K || n_pad < K || (n_pad & (n_pad - 1)) ||
      threads < 32 || threads > 32 * MAX_WARPS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)beam_step_merge_smem(W, n_pad);
  if (int rc = allow_smem((const void*)beam_merge_kernel, smem)) return rc;
  beam_merge_kernel<<<B, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int*)beam_ids, (const float*)beam_d, W, (const int*)cand_ids,
      (const float*)cand_d, K, ef, n_pad, (int*)out_ids, (float*)out_d);
  return (int)cudaGetLastError();
}
