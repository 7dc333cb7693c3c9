// The whole H-step imagination (the dream of an actor-critic update) as one
// kernel: actor MLP -> tanh-Normal action -> GRU on [z ‖ a] -> dynamics-prior
// MLP -> unimix, gumbel-argmax straight-through one-hot, for every step.
//
// Replaces: dreamer_tpu/ops/imagine_pallas.py, imagine_rollout_pallas
// (kernel _imagine_kernel).  It computes what that kernel computes, with its
// rounding points, not its block structure:
//
//   Dense:          f32 accumulation, rounded to bf16, then the bf16 bias
//                   added in bf16 (_split_dense / _dense_ref)
//   LayerNorm+SiLU: f32 over the true width, fast variance
//                   max(0, E[x^2] - E[x]^2), eps 1e-5, rounded once (_ln_silu);
//                   the SiLU by exp2 and a fast division (a few f32 ulps)
//   GRU gates:      f32 on the bf16 pre-activations; h' = (1-z) n + z h in f32
//   mu, sigma, a:   f32; sigma = softplus(clip(raw, -5, 2)) + min_std,
//                   a = tanh(mu + sigma * eps)
//   sampling:       f32 softmax, 1% unimix, argmax(log p + gum) with the
//                   first index on ties, z' = (onehot + p) - p in that order
//
// What bounds it on an H100: at the flagship shapes (B 50, T 30, GRU 600,
// 32x32 latents, hiddens 200, 3 actions) a rollout does 2 B T 3.66 M = 11 GFLOP
// (11 us at 989 TFLOP/s) and must move 24 MB (7.3 MB of bf16 weights, 9.8 MB
// of f32 outputs, 6.1 MB of gumbels: 7 us at 3.35 TB/s).  The recurrence is
// the real limit: each of the 30 steps depends on the last, and inside a step
// six products depend each on the one before, so a step costs six grid-wide
// hand-overs and six short products, each of them latency more than work.
//
// Design: one persistent cooperative launch, one block of 512 threads on
// every SM, the T loop inside every block.  Each layer's output columns (never
// its K) are split across the blocks by a plan that depends on the widths and
// the block count alone (make_plan, mirrored by ops/imagine_cuda.py
// imagine_plan): n8 column tiles of the Dense layers, whole latent rows of the
// prior's output layer, and for the GRU a run of hidden units whose three gate
// columns a block owns together, so that the gates stay in the block.  Each
// block copies its slice of the weights (with their biases) into shared
// memory once and keeps it for all T steps: at most 82,624 bytes a block at
// the flagship widths, 148,608 at the drone's (H 1024, hiddens 400).  A plan whose
// slices do not fit (fewer blocks than that: the drone's widths need 126, so
// on a 114-SM H100 PCIe they stream) copies each pass's tiles in again
// before the pass.  A step is six stages, a grid barrier after each:
//   S1  from the pre-step state x = [bf16 h | bf16 z]: actor Dense_0, the
//       GRU's h . W_h (rounded, with its bias) and the z rows of [z a] . W_i
//       (an f32 partial sum), for the block's columns
//   S2  actor Dense_1 on LayerNorm_0 of S1's output
//   S3  every block, the same code on the same numbers, so the same bits:
//       LayerNorm_1, the mu and sigma heads (one more tile in every block) and
//       the action of every row; then for the block's own hidden units the
//       action's rows of W_i (and the last Z mod 16 rows of z) added to the z
//       partial, one rounding and the bf16 bias, the gates and h'
//   S4  prior Dense_0 on bf16 h';  S5  prior Dense_1 on its LayerNorm
//   S6  prior Dense_2 on LayerNorm_1, the block's own latent rows, and the
//       sampler, one warp a latent row and one lane a class
// Every row of a step is in one product, on the tensor cores: mma.sync
// m16n8k16 (bf16 in, f32 sum) over 64-row groups (four m16 tiles).  The
// activations come from L2 by cp.async in chunks of 128 k: x through a ring
// of four, three in flight; a LayerNorm's input whole, its statistics and
// SiLU taken in shared memory before the first product.  The B fragments
// are read with ldmatrix from the resident weights, without a branch: a
// tile's fragment is zeroed by a select where the step lies outside its k
// range.  Intermediate activations live in L2 scratch that the wrapper
// allocates; they are read with ld.global.cg or cp.async (never the read-only
// path, which is not coherent within a launch) after the barrier.  The
// barrier is a counter in device memory: a release add from each block, an
// acquire poll, a trap after about four seconds rather than a hung card.
// It ends at the block count times the barriers crossed, and beside it each
// block writes the SM it ran on: the record of how the launch spread.
//
// Sum order, which makes a row's bits independent of the rows that share its
// launch and of the plan: the 16 warps are 4 m16 row tiles x 4 k slices;
// slice s sums the k16 steps whose index in the activation buffer is s mod 4,
// in ascending order, from zero; the four slice sums are then added in order
// ((s0 + s1) + s2) + s3.  LayerNorm statistics are summed by eight lanes a
// row in ascending 8-value units and a fixed shuffle tree.  The action's rows
// of W_i (and the last Z mod 16 rows of z) are added to the z partial by one
// thread in ascending k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <vector>

#include "gru_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;       // rows per row group: four m16 tiles
constexpr int kKC = 128;        // k per ring chunk: eight k16 steps
constexpr int kSlices = 4;      // k slices: a warp sums steps s and s + 4 of a chunk
constexpr int kMaxNT = 5;       // n8 tiles of one pass
constexpr int kSmemLimit = 232448;  // a block's shared memory on an H100
constexpr int kChunkBytes = kRows * kKC * 2;
constexpr int kMinSlots = 4;    // ring chunks: three in flight while one is multiplied
constexpr int kRedPitch = kMaxNT * 8;  // floats per row of the reduction and logit tiles
constexpr int kStatBytes = kRows * 2 * 4;
constexpr int kHeader = 8;
constexpr int kBlockFields = 9;
constexpr int kGroupFields = 4 + 3 * kMaxNT;
static_assert(kWarps == 4 * kSlices, "16 warps: 4 row tiles x 4 k slices");

// The kinds of column tile.  S1: kA0, kWH, kWI; S2: kA1; S3: kHD (the mu
// and sigma heads, in every block); S4: kD0; S5: kD1; S6: kD2.
enum Kind { kA0 = 0, kWH = 1, kWI = 2, kA1 = 3, kD0 = 4, kD1 = 5, kD2 = 6, kHD = 7 };

struct Widths {
  int H, Z, rows, classes, A, AH1, AH2, DH1, DH2;
};

__host__ __device__ inline int r16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct KRange {
  int k0, k1;
};

// The k range of a kind's products in its activation buffer.  S1 and S4 read
// x = [bf16 h, zeros to H16 | bf16 z, zeros to Z16]; the others read a
// LayerNorm of a Dense output, zero past its width.
// (Selects, not a switch: no indirect branch on the card's hot path.)
__host__ __device__ inline KRange k_range(const Widths& w, int kind) {
  const int H16 = r16(w.H);
  const int k1 = kind == kA0               ? H16 + r16(w.Z)
                 : kind == kWH || kind == kD0 ? H16
                 : kind == kWI             ? H16 + w.Z / 16 * 16
                 : kind == kA1             ? r16(w.AH1)
                 : kind == kD1             ? r16(w.DH1)
                 : kind == kHD             ? r16(w.AH2)
                                           : r16(w.DH2);
  return {kind == kWI ? H16 : 0, k1};
}

// A tile in shared memory: 8 weight rows of its k range, each padded by 16
// bytes so that the 8 rows an ldmatrix reads fall in 8 different bank
// groups, then its 8 columns' f32 biases.
__host__ __device__ inline int tile_pitch(const Widths& w, int kind) {
  const KRange r = k_range(w, kind);
  return (r.k1 - r.k0) * 2 + 16;
}

__host__ __device__ inline int tile_bytes(const Widths& w, int kind) {
  return 8 * tile_pitch(w, kind) + 32;
}

// The n8 tiles of the prior's output layer that hold latent row lr.
__host__ __device__ inline int d2_first(const Widths& w, int lr) { return lr * w.classes / 8; }
__host__ __device__ inline int d2_last(const Widths& w, int lr) {
  return ((lr + 1) * w.classes - 1) / 8;
}

// The inputs of W_i that S3 adds to the z partial: z past the last whole k16
// step, then the action.
__host__ __device__ inline int gi_tail(const Widths& w) { return w.Z - w.Z / 16 * 16 + w.A; }

// After a pass's last product the ring holds the slice sums (kSlices tiles)
// and then the logits of a latent row or the heads' 2A outputs.
constexpr int kRedBytes = kSlices * kRows * kRedPitch * 4;
__host__ __device__ inline int logit_bytes(const Widths& w) {
  return kRows * (kRedPitch > 2 * w.A ? kRedPitch : 2 * w.A) * 4;
}

// Ring chunks: enough for a whole LayerNorm input row group (its statistics
// are taken in shared memory before the first product) and for the slice
// sums and logits, at least kMinSlots.
inline int ring_slots(const Widths& w) {
  const int a = w.AH1 > w.AH2 ? w.AH1 : w.AH2, b = w.DH1 > w.DH2 ? w.DH1 : w.DH2;
  int s = cdiv(a > b ? a : b, kKC);
  const int sums = cdiv(kRedBytes + logit_bytes(w), kChunkBytes);
  s = s > sums ? s : sums;
  return s > kMinSlots ? s : kMinSlots;
}
inline int round128(int v) { return (v + 127) / 128 * 128; }

// The shared-memory regions after the weights, in this order:
//   ring    the activation chunks (bf16, 64 rows x 128 k each); after a
//           pass, the slice sums and then the logits
//   stats   a row group's LayerNorm mean and 1 / std
//   lnp     a LayerNorm's scale and bias
//   act     a row group's eps, then W_i's tail inputs (z tail, bf16 action)
//   gru     for each of the block's 3u GRU columns: b_i, then W_i's tail rows
//   tab     the block's record and its groups, from the plan's table
// The last two only when the weights are resident (stationary); a streamed
// plan reads them from device memory.
struct Regions {
  int ring, logits, stats, lnp, act, gru, tab, end;  // logits lies in the ring
};

inline Regions regions(const Widths& w, int wbytes, int umax, int ngmax, bool stationary) {
  const int slots = ring_slots(w);
  Regions g;
  g.ring = round128(wbytes);
  g.logits = g.ring + kRedBytes;
  g.stats = g.ring + slots * kChunkBytes;
  g.lnp = g.stats + kStatBytes;
  g.act = g.lnp + 2 * slots * kKC * 4;
  g.gru = g.act + r16(kRows * (w.A + gi_tail(w)) * 4);
  g.tab = g.gru + (stationary ? r16(3 * umax * (gi_tail(w) + 1) * 4) : 0);
  g.end = g.tab + (stationary ? r16((kBlockFields + ngmax * kGroupFields) * 4) : 0);
  return g;
}

// ---------------------------------------------------------------------------
// The plan: which columns each block owns, grouped into passes of at most
// kMaxNT tiles, and where each tile's weights sit in shared memory.  As a
// table of ints (ops/imagine_cuda.py imagine_plan builds the same):
//   header  nb, stationary, smem, groups, weight bytes, ring chunks, the most
//           GRU units and the most groups of a block
//   block   for each block: the first group of S1, S2, S3, S4, S5, S6, the
//           end, and its GRU units [u0, u1)
//   group   tiles, k0, k1, latent row (S6; else -1), then (kind, index,
//           shared-memory offset) for each of kMaxNT tiles (unused: 0)
// GRU units split evenly (block b: [H b / nb, H (b + 1) / nb)); every other
// layer's tiles (latent rows for the last) go one by one, layer by layer, to
// the block holding the fewest weight bytes so far (the first on a tie).
// Every block has all of the heads' tiles (S3).
// Stationary: all of a block's tiles at once, offsets running over the block;
// else a window as large as the largest group, offsets running over a group,
// with fewer than kMaxNT tiles a pass where kMaxNT would not fit.
int make_plan(const Widths& w, int nb, std::vector<int>& t) {
  if (nb < 1 || w.H < 1 || w.A < 1 || w.classes < 1 || w.classes > 32 || w.rows < 1 ||
      w.rows * w.classes != w.Z || w.AH1 < 1 || w.AH2 < 1 || w.DH1 < 1 || w.DH2 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int Zf = w.Z / 16 * 16;
  const int n_gru = Zf > 0 ? 2 : 1;  // W_h tiles, and W_i's z tiles unless Z < 16
  const int heads = cdiv(2 * w.A, 8);
  std::vector<long long> bytes(nb);
  std::vector<int> u0(nb), u1(nb);
  for (int b = 0; b < nb; ++b) {
    u0[b] = (int)((long long)w.H * b / nb);
    u1[b] = (int)((long long)w.H * (b + 1) / nb);
    const int tiles = cdiv(3 * (u1[b] - u0[b]), 8);
    bytes[b] = (long long)tiles * (tile_bytes(w, kWH) + (Zf > 0 ? tile_bytes(w, kWI) : 0)) +
               (long long)heads * tile_bytes(w, kHD);
  }
  const int kinds[5] = {kA0, kA1, kD0, kD1, kD2};
  const int units[5] = {cdiv(w.AH1, 8), cdiv(w.AH2, 8), cdiv(w.DH1, 8), cdiv(w.DH2, 8), w.rows};
  std::vector<std::vector<int>> own(5 * (size_t)nb);
  for (int l = 0; l < 5; ++l) {
    for (int i = 0; i < units[l]; ++i) {
      const int tiles = kinds[l] == kD2 ? d2_last(w, i) - d2_first(w, i) + 1 : 1;
      const long long ub = (long long)tiles * tile_bytes(w, kinds[l]);
      int best = 0;
      for (int b = 1; b < nb; ++b)
        if (bytes[b] < bytes[best]) best = b;
      own[(size_t)l * nb + best].push_back(i);
      bytes[best] += ub;
    }
  }
  struct Group {
    std::vector<int> kind, idx;
    int lr;
  };
  std::vector<Group> groups;
  std::vector<int> rec((size_t)nb * kBlockFields);
  int cap = kMaxNT;  // tiles a pass
  auto add = [&](std::vector<int>& kinds_, std::vector<int>& idx_) {
    for (size_t s = 0; s < kinds_.size(); s += cap) {
      Group g;
      g.lr = -1;
      for (size_t i = s; i < kinds_.size() && i < s + cap; ++i) {
        g.kind.push_back(kinds_[i]);
        g.idx.push_back(idx_[i]);
      }
      groups.push_back(g);
    }
  };
  long long block_max = 0, group_max = 0;
  int ngmax = 0, umax = 0;
  for (int b = 0; b < nb; ++b) umax = u1[b] - u0[b] > umax ? u1[b] - u0[b] : umax;
  auto build = [&]() {
    groups.clear();
    for (int b = 0; b < nb; ++b) {
      int* r = &rec[(size_t)b * kBlockFields];
      std::vector<int> k, x;
      r[0] = (int)groups.size();
      for (int i : own[(size_t)0 * nb + b]) { k.push_back(kA0); x.push_back(i); }
      const int gt = cdiv(3 * (u1[b] - u0[b]), 8);
      for (int p = 0; p < n_gru; ++p)
        for (int j = 0; j < gt; ++j) { k.push_back(p == 0 ? kWH : kWI); x.push_back(j); }
      add(k, x);
      const int stage_kind[4] = {kA1, kHD, kD0, kD1}, layer[4] = {1, -1, 2, 3};  // own[]
      for (int s = 0; s < 4; ++s) {
        r[1 + s] = (int)groups.size();
        k.clear();
        x.clear();
        if (stage_kind[s] == kHD) {
          for (int j = 0; j < heads; ++j) { k.push_back(kHD); x.push_back(j); }
        } else {
          for (int i : own[(size_t)layer[s] * nb + b]) {
            k.push_back(stage_kind[s]);
            x.push_back(i);
          }
        }
        add(k, x);
      }
      r[5] = (int)groups.size();
      for (int lr : own[(size_t)4 * nb + b]) {
        Group g;
        g.lr = lr;
        for (int i = d2_first(w, lr); i <= d2_last(w, lr); ++i) {
          g.kind.push_back(kD2);
          g.idx.push_back(i);
        }
        groups.push_back(g);
      }
      r[6] = (int)groups.size();
      r[7] = u0[b];
      r[8] = u1[b];
    }
    block_max = group_max = 0;
    ngmax = 0;
    for (int b = 0; b < nb; ++b) {
      const int ng = rec[(size_t)b * kBlockFields + 6] - rec[(size_t)b * kBlockFields];
      ngmax = ng > ngmax ? ng : ngmax;
      long long sum = 0;
      for (int g = rec[(size_t)b * kBlockFields]; g < rec[(size_t)b * kBlockFields + 6]; ++g) {
        long long gs = 0;
        for (int kd : groups[g].kind) gs += tile_bytes(w, kd);
        sum += gs;
        group_max = gs > group_max ? gs : group_max;
      }
      block_max = sum > block_max ? sum : block_max;
    }
  };
  build();
  const int limit = kSmemLimit;
  const bool stationary = block_max < limit &&
                          regions(w, (int)block_max, umax, ngmax, true).end <= limit;
  // Streamed: fewer tiles a pass until the largest pass's window fits.
  while (!stationary && regions(w, (int)group_max, umax, ngmax, false).end > limit && cap > 1) {
    --cap;
    build();
  }
  const long long wbytes = stationary ? block_max : group_max;
  if (wbytes >= limit) return (int)cudaErrorInvalidValue;
  const long long smem = regions(w, (int)wbytes, umax, ngmax, stationary).end;
  if (smem > limit) return (int)cudaErrorInvalidValue;

  t.assign(kHeader, 0);
  t[0] = nb;
  t[1] = stationary ? 1 : 0;
  t[2] = (int)smem;
  t[3] = (int)groups.size();
  t[4] = (int)wbytes;
  t[5] = ring_slots(w);
  t[6] = umax;
  t[7] = ngmax;
  t.insert(t.end(), rec.begin(), rec.end());
  for (int b = 0; b < nb; ++b) {
    int off = 0;
    for (int g = rec[(size_t)b * kBlockFields]; g < rec[(size_t)b * kBlockFields + 6]; ++g) {
      const Group& G = groups[g];
      if (!stationary) off = 0;
      int k0 = 1 << 30, k1 = 0;
      for (int kd : G.kind) {
        const KRange kr = k_range(w, kd);
        k0 = kr.k0 < k0 ? kr.k0 : k0;
        k1 = kr.k1 > k1 ? kr.k1 : k1;
      }
      t.push_back((int)G.kind.size());
      t.push_back(k0);
      t.push_back(k1);
      t.push_back(G.lr);
      for (int i = 0; i < kMaxNT; ++i) {
        if (i < (int)G.kind.size()) {
          t.push_back(G.kind[i]);
          t.push_back(G.idx[i]);
          t.push_back(off);
          off += tile_bytes(w, G.kind[i]);
        } else {
          t.push_back(0);
          t.push_back(0);
          t.push_back(0);
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The kernel.  Every device function below is inlined into it and called
// from one place, so that the launch's parameters stay in the constant bank.

struct Dims {
  Widths w;
  int N, T, nb, stationary, tail;
  int K_a0, K_a1, K_head, K_gi, K_gh, K_d0, K_d1, K_d2;  // weight row lengths (round8)
  int H16, Zf, ldx, ld_a0, ld_a1, ld_d0, ld_d1;          // activation buffer widths
  Regions at;                                            // shared-memory offsets (bytes)
  int lnp_stride;                                        // floats from scale to bias
  float keep, mix, min_std;                              // 1 - unimix, unimix / classes
};

struct Operands {
  const bf16 *a0w, *a1w, *muw, *sgw, *wi, *wh, *d0w, *d1w, *d2w;
  const float *a0b, *al0s, *al0b, *a1b, *al1s, *al1b, *mub, *sgb;
  const float *bi, *bh;
  const float *d0b, *dl0s, *dl0b, *d1b, *dl1s, *dl1b, *d2b;
  const float *h0, *z0, *eps, *gum;
  float *h_seq, *z_seq, *a_seq, *mu_seq, *sig_seq, *h_fin, *z_fin;
  // Scratch: the launch's record (the barrier's counter, then for each block
  // the SM it ran on plus one); x; the Dense outputs; the GRU's f32 sums.
  unsigned* count;
  bf16 *xs, *ya0, *ya1, *yd0, *yd1;
  float *gh, *giz;
  const int* table;
};

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

// A bf16 written in this launch by any block: read through L2.
__device__ __forceinline__ float ldcg_bf16(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// softplus as jax.nn.softplus computes it: logaddexp(v, 0).
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// LayerNorm + SiLU of one value in f32, to be rounded to bf16 once by the
// caller.  The SiLU by the hardware's exp2 and a fast division: within an
// ulp or two of f32, and the same bits in every block.
__device__ __forceinline__ float ln_silu(float v, float mean, float rs, float scale, float bias) {
  const float y = (v - mean) * (rs * scale) + bias;
  return __fdividef(y, 1.0f + __expf(-y));
}

// 4 bytes from global to shared memory (an input, cached on the way).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Every block arrives (a release at the card's scope, after the block's own
// barrier, so that its threads' writes go with it), then waits until the
// count reaches `target` (the barrier's index times the block count), reading
// it with acquire.  Writes before it are visible to ld.global.cg and cp.async
// reads after it.  A block that never arrives traps after about four
// seconds: an error, not a hung card.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    const long long start = clock64();
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (clock64() - start > 8000000000LL) __trap();
    }
  }
  __syncthreads();
}

// Where a tile's row n comes from: the weight row (null past the layer), the
// k map ([0, seg1) from k, [s2, s2 + len2) from off2 + k - s2, else 0) and
// the column's bias.
struct SrcRow {
  const bf16* row;
  int seg1, s2, len2, off2;
  float bias;
};

__device__ __forceinline__ SrcRow src_row(const Dims& d, const Operands& o, int kind, int idx,
                                          int n, int u0, int u1) {
  const Widths& w = d.w;
  SrcRow s{nullptr, 0, 0, 0, 0, 0.0f};
  const int col = 8 * idx + n;
  const int u = u1 - u0;
  switch (kind) {
    case kA0:
      if (col < w.AH1) s = {o.a0w + (size_t)col * d.K_a0, w.H, d.H16, w.Z, w.H, o.a0b[col]};
      break;
    case kA1:
      if (col < w.AH2) s = {o.a1w + (size_t)col * d.K_a1, w.AH1, 0, 0, 0, o.a1b[col]};
      break;
    case kD0:
      if (col < w.DH1) s = {o.d0w + (size_t)col * d.K_d0, w.H, 0, 0, 0, o.d0b[col]};
      break;
    case kD1:
      if (col < w.DH2) s = {o.d1w + (size_t)col * d.K_d1, w.DH1, 0, 0, 0, o.d1b[col]};
      break;
    case kD2:
      if (col < w.Z) s = {o.d2w + (size_t)col * d.K_d2, w.DH2, 0, 0, 0, o.d2b[col]};
      break;
    case kHD:  // mu's rows, then sigma's
      if (col < w.A) s = {o.muw + (size_t)col * d.K_head, w.AH2, 0, 0, 0, o.mub[col]};
      else if (col < 2 * w.A)
        s = {o.sgw + (size_t)(col - w.A) * d.K_head, w.AH2, 0, 0, 0, o.sgb[col - w.A]};
      break;
    default:  // kWH, kWI: packed column c is gate c / u of unit u0 + c % u
      if (col < 3 * u) {
        const int grow = (col / u) * w.H + u0 + col % u;
        s = kind == kWH ? SrcRow{o.wh + (size_t)grow * d.K_gh, w.H, 0, 0, 0, o.bh[grow]}
                        : SrcRow{o.wi + (size_t)grow * d.K_gi, d.Zf, 0, 0, 0, o.bi[grow]};
      }
  }
  return s;
}

// A tile's weights and biases into shared memory at dst.
__device__ __forceinline__ void load_tile(const Dims& d, const Operands& o, int kind, int idx,
                                          int u0, int u1, unsigned char* dst) {
  const KRange r = k_range(d.w, kind);
  const int units = (r.k1 - r.k0) / 8, pitch = tile_pitch(d.w, kind);
  for (int q = threadIdx.x; q < 8 * units + 8; q += kThreads) {
    if (q >= 8 * units) {
      reinterpret_cast<float*>(dst + 8 * pitch)[q - 8 * units] =
          src_row(d, o, kind, idx, q - 8 * units, u0, u1).bias;
      continue;
    }
    const int n = q / units, k = 8 * (q % units);
    const SrcRow s = src_row(d, o, kind, idx, n, u0, u1);
    uint4 out = make_uint4(0, 0, 0, 0);
    if (s.row != nullptr) {
      if (k + 8 <= s.seg1) {
        out = __ldg(reinterpret_cast<const uint4*>(s.row + k));
      } else if (k >= s.s2 && k + 8 <= s.s2 + s.len2 && (s.off2 + k - s.s2) % 8 == 0) {
        out = __ldg(reinterpret_cast<const uint4*>(s.row + s.off2 + k - s.s2));
      } else {
        unsigned short e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = k + i;
          const bool in2 = kk >= s.s2 && kk < s.s2 + s.len2;
          const int src = kk < s.seg1 ? kk : (in2 ? s.off2 + kk - s.s2 : -1);
          e[i] = src >= 0 ? __bfloat16_as_ushort(s.row[src]) : (unsigned short)0;
        }
        out = make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                         e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + n * pitch + 2 * k) = out;
  }
}

// The activations of one pass: a bf16 buffer (rows of ld) and, for a
// LayerNorm stage, its width, scale and bias.
struct ASrc {
  const bf16* p;
  int ld, width;
  const float *scale, *bias;
};

// A thread's two 16-byte units of ring chunk c of row group rg, (row, unit)
// = (u / 16, u % 16), copied by cp.async through L2 (zeros past the rows and
// the buffer).  Not committed.
__device__ __forceinline__ void copy_chunk(const ASrc& a, int N, int rg, int c, uint32_t slot) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int r = u >> 4, cu = u & 15, R = rg * kRows + r, k = c * kKC + 8 * cu;
    const bool ok = R < N && k < a.ld;
    gru::cp_async16(slot + gru::swz(r, cu, kKC * 2), ok ? a.p + (size_t)R * a.ld + k : a.p,
                    ok ? 16 : 0);
  }
}

// The LayerNorm + SiLU input of a row group, whole in the ring: its chunks
// and the LayerNorm's scale and bias copied in (with any copies issued
// before), each row's statistics, then every value replaced by
// bf16(SiLU(LayerNorm)), zero past the width.
__device__ __forceinline__ void ln_rows(const Dims& d, const ASrc& a, int rg, int nch,
                                        unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = smem + d.at.ring;
  float* stats = reinterpret_cast<float*>(smem + d.at.stats);
  const float* lnp = reinterpret_cast<const float*>(smem + d.at.lnp);
  const uint32_t base = gru::smem_u32(ring), pbase = gru::smem_u32(lnp);
  for (int c = 0; c < nch; ++c) copy_chunk(a, d.N, rg, c, base + c * kChunkBytes);
  const int n4 = cdiv(a.width, 4);
  for (int q = threadIdx.x; q < 2 * n4; q += kThreads) {
    const int which = q / n4, j = q % n4;
    gru::cp_async16(pbase + 4 * (which * d.lnp_stride + 4 * j), (which ? a.bias : a.scale) + 4 * j,
                    4 * min(4, a.width - 4 * j));
  }
  gru::cp_async_commit();
  gru::cp_async_wait<0>();
  __syncthreads();
  {
    // Eight lanes a row: lane l of the eight sums the 8-value units l, l + 8,
    // ... in ascending k, then three shuffle levels add the eight.
    const int r = threadIdx.x >> 3, l = threadIdx.x & 7;
    float s = 0.0f, sq = 0.0f;
    for (int j = l; 8 * j < a.width; j += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(ring + (j >> 4) * kChunkBytes +
                                                      gru::swz(r, j & 15, kKC * 2));
      const uint32_t qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[e]));
        const float x0 = 8 * j + 2 * e < a.width ? f.x : 0.0f;
        const float x1 = 8 * j + 2 * e + 1 < a.width ? f.y : 0.0f;
        s += x0;
        sq += x0 * x0;
        s += x1;
        sq += x1 * x1;
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (l == 0) {
      const float mean = s / (float)a.width;
      const float var = fmaxf(0.0f, sq / (float)a.width - mean * mean);
      stats[2 * r] = mean;
      stats[2 * r + 1] = rsqrtf(var + 1e-5f);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nch * kRows * 16; q += kThreads) {
    const int c = q / (kRows * 16), r = (q >> 4) % kRows, cu = q & 15;
    const int k = c * kKC + 8 * cu;
    if (rg * kRows + r >= d.N) continue;  // copied as zeros
    uint4* at = reinterpret_cast<uint4*>(ring + c * kChunkBytes + gru::swz(r, cu, kKC * 2));
    if (k >= a.width) {
      *at = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4 x = *at;
    const uint32_t xv[4] = {x.x, x.y, x.z, x.w};
    const float mean = stats[2 * r], rs = stats[2 * r + 1];
    const float4 sc0 = *reinterpret_cast<const float4*>(lnp + k);
    const float4 sc1 = *reinterpret_cast<const float4*>(lnp + k + 4);
    const float4 bi0 = *reinterpret_cast<const float4*>(lnp + d.lnp_stride + k);
    const float4 bi1 = *reinterpret_cast<const float4*>(lnp + d.lnp_stride + k + 4);
    const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w, sc1.x, sc1.y, sc1.z, sc1.w};
    const float bs[8] = {bi0.x, bi0.y, bi0.z, bi0.w, bi1.x, bi1.y, bi1.z, bi1.w};
    uint32_t yv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[e]));
      const float y0 = ln_silu(f.x, mean, rs, sc[2 * e], bs[2 * e]);
      const float y1 = ln_silu(f.y, mean, rs, sc[2 * e + 1], bs[2 * e + 1]);
      const __nv_bfloat162 y = __floats2bfloat162_rn(k + 2 * e < a.width ? y0 : 0.0f,
                                                     k + 2 * e + 1 < a.width ? y1 : 0.0f);
      yv[e] = *reinterpret_cast<const uint32_t*>(&y);
    }
    *at = make_uint4(yv[0], yv[1], yv[2], yv[3]);
  }
  __syncthreads();
}

// One output element of a pass, after the slice sums were added: its
// rounding, its bias b and its destination by the tile's kind (an if chain
// on a kind the warp shares, not a switch).
__device__ __forceinline__ void put(const Dims& d, const Operands& o, int kind, int idx, int n,
                                    int R, int row, float v, float b, int u0, int u1, int gcol0,
                                    float* logits) {
  const Widths& w = d.w;
  const int col = 8 * idx + n;
  if (kind == kWH || kind == kWI) {
    const int u = u1 - u0;
    if (col < 3 * u) {
      const size_t at = (size_t)R * 3 * w.H + (col / u) * w.H + u0 + col % u;
      if (kind == kWH) o.gh[at] = bf16r(bf16r(v) + b);
      else o.giz[at] = v;
    }
  } else if (kind == kD2) {
    if (col < w.Z) logits[row * kRedPitch + col - gcol0] = bf16r(bf16r(v) + b);
  } else if (kind == kHD) {
    if (col < 2 * w.A) logits[row * 2 * w.A + col] = bf16r(bf16r(v) + b);
  } else {
    bf16* y = kind == kA0 ? o.ya0 : kind == kA1 ? o.ya1 : kind == kD0 ? o.yd0 : o.yd1;
    const int ld = kind == kA0 ? d.ld_a0 : kind == kA1 ? d.ld_a1 : kind == kD0 ? d.ld_d0 : d.ld_d1;
    const int width = kind == kA0 ? w.AH1 : kind == kA1 ? w.AH2 : kind == kD0 ? w.DH1 : w.DH2;
    if (col < width) y[(size_t)R * ld + col] = __float2bfloat16(bf16r(v) + b);
  }
}

// Warp (rt, ks) = (warp % 4, warp / 4): k16 steps ks and ks + 4 of chunk c
// on m16 row tile rt, for the group's NT tiles.  Branch-free: every tile's
// fragment is loaded from an address clamped into its rows and zeroed by a
// select where the step lies outside the tile's k range; a product with a
// zero B adds an exact zero, so each sum is the one over its own range.
template <int NT>
__device__ __forceinline__ void mma_chunk(int c, uint32_t slot, const int (&tk0)[kMaxNT],
                                          const int (&tk1)[kMaxNT], const uint32_t (&wb)[kMaxNT],
                                          float (&acc)[kMaxNT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rt = warp & 3, ks = warp >> 2;
#pragma unroll
  for (int j = 0; j < kKC / 16 / kSlices; ++j) {
    const int kk = ks + kSlices * j;
    const int k = c * kKC + 16 * kk;
    uint32_t af[4], bfr[NT][2];
    gru::ldsm_x4(slot + gru::swz(rt * 16 + (lane & 15), 2 * kk + (lane >> 4), kKC * 2), af);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      gru::ldsm_x2(wb[i] + 2 * max(0, min(k - tk0[i], tk1[i] - tk0[i] - 16)), bfr[i]);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const bool on = k >= tk0[i] && k < tk1[i];
      bfr[i][0] = on ? bfr[i][0] : 0u;
      bfr[i][1] = on ? bfr[i][1] : 0u;
      gru::mma_bf16(acc[i], af, bfr[i]);
    }
  }
}

// A pass's products over chunks [c0, c1) of its activations: a LayerNorm
// input already whole in the ring (c0 is 0), or x through kMinSlots chunks
// of the ring with kMinSlots - 1 in flight.
template <int NT>
__device__ __forceinline__ void products(const Dims& d, const ASrc& a, int rg, int c0, int c1,
                                         unsigned char* smem, const int (&tk0)[kMaxNT],
                                         const int (&tk1)[kMaxNT], const uint32_t (&wb)[kMaxNT],
                                         float (&acc)[kMaxNT][4]) {
  const uint32_t rbase = gru::smem_u32(smem + d.at.ring);
  if (a.scale != nullptr) {
    for (int c = 0; c < c1; ++c) mma_chunk<NT>(c, rbase + c * kChunkBytes, tk0, tk1, wb, acc);
    return;
  }
  for (int p = 0; p < kMinSlots - 1; ++p) {
    if (c0 + p < c1) copy_chunk(a, d.N, rg, c0 + p, rbase + p * kChunkBytes);
    gru::cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    gru::cp_async_wait<kMinSlots - 2>();
    __syncthreads();
    const int next = c + kMinSlots - 1;
    if (next < c1) copy_chunk(a, d.N, rg, next, rbase + ((next - c0) % kMinSlots) * kChunkBytes);
    gru::cp_async_commit();
    mma_chunk<NT>(c, rbase + ((c - c0) % kMinSlots) * kChunkBytes, tk0, tk1, wb, acc);
  }
}

// One group of tiles (G, in shared memory) over one row group: the chunk
// loop on the tensor cores, the slice sums added in order, each element put.
__device__ __forceinline__ void run_pass(const Dims& d, const Operands& o, unsigned char* smem,
                                         const int* G, const ASrc& a, int rg, int u0, int u1) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = warp & 3, ks = warp >> 2;
  const int nt = G[0], gk0 = G[1], gk1 = G[2];
  const uint32_t sbase = gru::smem_u32(smem);
  unsigned char* ring = smem + d.at.ring;
  int tk0[kMaxNT], tk1[kMaxNT];
  uint32_t wb[kMaxNT];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    const int t = i < nt ? i : 0, kind = G[4 + 3 * t];
    const KRange r = k_range(d.w, kind);
    tk0[i] = r.k0;
    tk1[i] = r.k1;
    wb[i] = sbase + G[6 + 3 * t] + (lane & 7) * tile_pitch(d.w, kind) + ((lane >> 3) & 1) * 16;
  }
  const int c0 = gk0 / kKC, c1 = cdiv(gk1, kKC);
  float acc[kMaxNT][4];
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  if (a.scale != nullptr) ln_rows(d, a, rg, c1, smem);
  // The products, over as many tiles as the group has.
  if (nt == 1) products<1>(d, a, rg, c0, c1, smem, tk0, tk1, wb, acc);
  else if (nt == 2) products<2>(d, a, rg, c0, c1, smem, tk0, tk1, wb, acc);
  else if (nt == 3) products<3>(d, a, rg, c0, c1, smem, tk0, tk1, wb, acc);
  else if (nt == 4) products<4>(d, a, rg, c0, c1, smem, tk0, tk1, wb, acc);
  else products<kMaxNT>(d, a, rg, c0, c1, smem, tk0, tk1, wb, acc);
  __syncthreads();
  // The slice sums, added in the order s0, s1, s2, s3, then put.
  float* red = reinterpret_cast<float*>(ring);
  float* logits = reinterpret_cast<float*>(smem + d.at.logits);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i)
    if (i < nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rt * 16 + g + 8 * (e >> 1), col = 8 * i + 2 * tq + (e & 1);
        red[(ks * kRows + row) * kRedPitch + col] = acc[i][e];
      }
  __syncthreads();
  // One element a thread in each tile: (row, column) = (tid / 8, tid % 8).
  static_assert(kRows * 8 == kThreads, "one element of a tile per thread");
  const int gcol0 = 8 * G[5], row = tid >> 3, n = tid & 7, R = rg * kRows + row;
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (i < nt && R < d.N) {
      const int col = 8 * i + n;
      float sum = red[row * kRedPitch + col];
#pragma unroll
      for (int p = 1; p < kSlices; ++p) sum += red[(p * kRows + row) * kRedPitch + col];
      const float b = reinterpret_cast<const float*>(smem + G[6 + 3 * i] +
                                                     8 * (tk1[i] - tk0[i]) * 2 + 128)[n];
      put(d, o, G[4 + 3 * i], G[5 + 3 * i], n, R, row, sum, b, u0, u1, gcol0, logits);
    }
  }
  __syncthreads();
}

// The sampler of latent row lr over a row group, from the logit tile.
__device__ __forceinline__ void sample(const Dims& d, const Operands& o, int lr, int gcol0,
                                       int rg, int t, const unsigned char* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = d.w.classes, Z = d.w.Z;
  const bool on = lane < k;
  const int col = lr * k + lane;
  const float* logits = reinterpret_cast<const float*>(smem + d.at.logits);
  float* zdst = t + 1 < d.T ? o.z_seq + (size_t)(t + 1) * d.N * Z : o.z_fin;
  float gum[kRows / kWarps];  // the warp's rows' gumbels, loaded together
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int R = rg * kRows + warp + kWarps * i;
    gum[i] = on && R < d.N ? __ldg(o.gum + ((size_t)t * d.N + R) * Z + col) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int r = warp + kWarps * i, R = rg * kRows + r;
    if (R >= d.N) break;
    const float l = on ? logits[r * kRedPitch + col - gcol0] : -INFINITY;
    const float m = warp_max(l);
    const float e = on ? expf(l - m) : 0.0f;
    const float s = warp_sum(e);
    const float p = d.keep * (e / s) + d.mix;
    const float score = on ? logf(p) + gum[i] : -INFINITY;
    const float best = warp_max(score);
    const int win = warp_min(on && score >= best ? lane : k);
    if (on) {
      const float onehot = lane == win ? 1.0f : 0.0f;
      const float zv = (onehot + p) - p;
      zdst[(size_t)R * Z + col] = zv;
      o.xs[(size_t)R * d.ldx + d.H16 + col] = __float2bfloat16(zv);
    }
  }
  __syncthreads();
}

// S3 after the heads' pass over a row group: the action of every row (every
// block alike), then the GRU's gates for the block's own units.
__device__ __forceinline__ void gates(const Dims& d, const Operands& o, unsigned char* smem,
                                      int rg, int t, int u0, int u1) {
  const Widths& w = d.w;
  const int tid = threadIdx.x, A = w.A, H = w.H, Z = w.Z, tail = d.tail, zt = Z - d.Zf;
  const int u = u1 - u0;
  const float* hv = reinterpret_cast<const float*>(smem + d.at.logits);
  const float* eps = reinterpret_cast<const float*>(smem + d.at.act);
  float* xt = reinterpret_cast<float*>(smem + d.at.act) + kRows * A;  // [z tail | action]
  const float* gc = reinterpret_cast<const float*>(smem + d.at.gru);  // stationary only
  const float* hcur = o.h_seq + (size_t)t * d.N * H;
  float* hdst = t + 1 < d.T ? o.h_seq + (size_t)(t + 1) * d.N * H : o.h_fin;
  for (int q = tid; q < kRows * A; q += kThreads) {
    const int r = q / A, i = q % A, R = rg * kRows + r;
    if (R >= d.N) break;
    const float mu = hv[r * 2 * A + i];
    const float sigma = softplus(fminf(fmaxf(hv[r * 2 * A + A + i], -5.0f), 2.0f)) + d.min_std;
    const float a = tanhf(mu + sigma * eps[q]);
    xt[r * tail + zt + i] = bf16r(a);
    if (blockIdx.x == 0) {
      const size_t at = ((size_t)t * d.N + R) * A + i;
      o.mu_seq[at] = mu;
      o.sig_seq[at] = sigma;
      o.a_seq[at] = a;
    }
  }
  for (int q = tid; q < kRows * zt; q += kThreads) {
    const int r = q / zt, R = rg * kRows + r;
    if (R >= d.N) break;
    xt[r * tail + q % zt] = ldcg_bf16(o.xs + (size_t)R * d.ldx + d.H16 + d.Zf + q % zt);
  }
  __syncthreads();
  for (int p = tid; p < kRows * u; p += kThreads) {
    const int r = p / u, jj = p % u, j = u0 + jj, R = rg * kRows + r;
    if (R >= d.N) break;
    float part[3], gh[3], gi[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const size_t at = (size_t)R * 3 * H + g * H + j;
      part[g] = d.Zf > 0 ? __ldcg(o.giz + at) : 0.0f;
      gh[g] = __ldcg(o.gh + at);
    }
    const float h = __ldcg(hcur + (size_t)R * H + j);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float s = part[g];
      if (d.stationary) {
        const float* c = gc + (g * u + jj) * (tail + 1);  // b_i, then W_i's tail row
        for (int k = 0; k < tail; ++k) s = fmaf(xt[r * tail + k], c[1 + k], s);
        gi[g] = bf16r(bf16r(s) + c[0]);
      } else {
        const bf16* c = o.wi + (size_t)(g * H + j) * d.K_gi + d.Zf;
        for (int k = 0; k < tail; ++k) s = fmaf(xt[r * tail + k], __bfloat162float(c[k]), s);
        gi[g] = bf16r(bf16r(s) + o.bi[g * H + j]);
      }
    }
    const float rg_ = sigmoid(gi[0] + gh[0]);
    const float zg = sigmoid(gi[1] + gh[1]);
    const float n = tanhf(gi[2] + rg_ * gh[2]);
    const float hn = (1.0f - zg) * n + zg * h;
    hdst[(size_t)R * H + j] = hn;
    o.xs[(size_t)R * d.ldx + j] = __float2bfloat16(hn);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) imagine_kernel(const __grid_constant__ Dims d,
                                                               const __grid_constant__ Operands o) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Widths& w = d.w;
  const int tid = threadIdx.x;
  if (tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    o.count[1 + blockIdx.x] = sm + 1;
  }
  // The block's record and its groups: copied into shared memory when the
  // weights are resident, else read where they are.
  const int* rec = o.table + kHeader + blockIdx.x * kBlockFields;
  const int g0 = rec[0], ng = rec[6] - g0;
  const int* groups = o.table + kHeader + d.nb * kBlockFields + (size_t)g0 * kGroupFields;
  if (d.stationary) {
    int* tab = reinterpret_cast<int*>(smem + d.at.tab);
    for (int q = tid; q < kBlockFields + ng * kGroupFields; q += kThreads)
      tab[q] = q < kBlockFields ? rec[q] : groups[q - kBlockFields];
    __syncthreads();
    rec = tab;
    groups = tab + kBlockFields;
  }
  const int u0 = rec[7], u1 = rec[8], u = u1 - u0;
  // x, h_seq[0] and z_seq[0] from h0 and z0, rows spread over the blocks.
  for (int R = blockIdx.x; R < d.N; R += gridDim.x) {
    for (int k = tid; k < d.ldx; k += kThreads) {
      const bool in_z = k >= d.H16 && k < d.H16 + w.Z;
      const float v = k < w.H ? o.h0[(size_t)R * w.H + k]
                              : (in_z ? o.z0[(size_t)R * w.Z + k - d.H16] : 0.0f);
      o.xs[(size_t)R * d.ldx + k] = __float2bfloat16(v);
    }
    for (int k = tid; k < w.H; k += kThreads)
      o.h_seq[(size_t)R * w.H + k] = o.h0[(size_t)R * w.H + k];
    for (int k = tid; k < w.Z; k += kThreads)
      o.z_seq[(size_t)R * w.Z + k] = o.z0[(size_t)R * w.Z + k];
  }
  // b_i and W_i's tail rows of the block's 3u GRU columns.
  if (d.stationary) {
    float* gc = reinterpret_cast<float*>(smem + d.at.gru);
    for (int q = tid; q < 3 * u * (d.tail + 1); q += kThreads) {
      const int c = q / (d.tail + 1), e = q % (d.tail + 1);
      const int grow = (c / u) * w.H + u0 + c % u;
      gc[q] = e == 0 ? o.bi[grow] : __bfloat162float(o.wi[(size_t)grow * d.K_gi + d.Zf + e - 1]);
    }
  }
  if (d.stationary) {
    for (int gi = 0; gi < ng; ++gi) {
      const int* G = groups + gi * kGroupFields;
      for (int i = 0; i < G[0]; ++i)
        load_tile(d, o, G[4 + 3 * i], G[5 + 3 * i], u0, u1, smem + G[6 + 3 * i]);
    }
  }
  unsigned barriers = 0;
  grid_sync(o.count, ++barriers * gridDim.x);
  for (int t = 0; t < d.T; ++t) {
    for (int st = 0; st < 6; ++st) {
      // S1 and S4 read x; S2, S3, S5 and S6 a LayerNorm of a Dense output.
      const ASrc a = st == 0 || st == 3 ? ASrc{o.xs, d.ldx, d.ldx, nullptr, nullptr}
                   : st == 1           ? ASrc{o.ya0, d.ld_a0, w.AH1, o.al0s, o.al0b}
                   : st == 2           ? ASrc{o.ya1, d.ld_a1, w.AH2, o.al1s, o.al1b}
                   : st == 4           ? ASrc{o.yd0, d.ld_d0, w.DH1, o.dl0s, o.dl0b}
                                       : ASrc{o.yd1, d.ld_d1, w.DH2, o.dl1s, o.dl1b};
      for (int rg = 0; rg * kRows < d.N; ++rg) {
        if (st == 2) {  // this row group's eps, landing with the heads' inputs
          const uint32_t e = gru::smem_u32(smem + d.at.act);
          for (int q = tid; q < kRows * w.A; q += kThreads) {
            const int R = rg * kRows + q / w.A;
            if (R < d.N) cp_async4(e + 4 * q, o.eps + ((size_t)t * d.N + R) * w.A + q % w.A);
          }
        }
        for (int gi = rec[st]; gi < rec[st + 1]; ++gi) {
          const int* G = groups + (gi - g0) * kGroupFields;
          if (!d.stationary) {  // the group's tiles into the window
            __syncthreads();
            for (int i = 0; i < G[0]; ++i)
              load_tile(d, o, G[4 + 3 * i], G[5 + 3 * i], u0, u1, smem + G[6 + 3 * i]);
            __syncthreads();
          }
          run_pass(d, o, smem, G, a, rg, u0, u1);
          if (G[3] >= 0) sample(d, o, G[3], 8 * G[5], rg, t, smem);
        }
        if (st == 2) gates(d, o, smem, rg, t, u0, u1);
      }
      if (t + 1 < d.T || st < 5) grid_sync(o.count, ++barriers * gridDim.x);
    }
  }
}

}  // namespace

// The plan for widths (H Z rows classes A AH1 AH2 DH1 DH2) over nb blocks
// as make_plan's table: up to `cap` ints into out, its length into *len.
// Returns cudaErrorInvalidValue for widths or a block count it does not take.
extern "C" int dt_imagine_plan(const int* widths, int nb, int* out, int cap, int* len) {
  const Widths w{widths[0], widths[1], widths[2], widths[3], widths[4],
                 widths[5], widths[6], widths[7], widths[8]};
  std::vector<int> t;
  const int status = make_plan(w, nb, t);
  if (status != 0) return status;
  *len = (int)t.size();
  for (int i = 0; i < (int)t.size() && i < cap; ++i) out[i] = t[i];
  return 0;
}

// ptrs: the 26 weight operands in the order of ops/imagine_cuda.py
// (actor a0w a0b al0s al0b a1w a1b al1s al1b muw mub sgw sgb; GRU wi wh bi bh;
// dyn d0w d0b dl0s dl0b d1w d1b dl1s dl1b d2w d2b), then h0 z0 eps gum, then
// the outputs h_seq z_seq a_seq mu_seq sig_seq h_fin z_fin, then the scratch
// record (u32: the barrier's count, then each block's SM plus one; 1 + nb)
// xs ya0 ya1 yd0 yd1 (bf16) gh giz (f32) and the plan's table on the card
// (int32): 46 pointers.  Weights are bf16 (rows, round8(in)),
// biases bf16 values as f32, LayerNorm scales and biases f32; every other
// operand f32.
// dims: B T H Z rows classes A AH1 AH2 DH1 DH2, then the plan's nb,
// stationary, smem, weight bytes, ring chunks, most GRU units and most groups
// of a block (its table's header).
// Returns the cooperative launch's status: cudaErrorCooperativeLaunchTooLarge
// when the card cannot hold nb blocks at once, cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int dt_imagine_rollout(const void* const* ptrs, const int* dims, float unimix,
                                  float min_std, void* stream) {
  Dims d;
  d.N = dims[0];
  d.T = dims[1];
  d.w = Widths{dims[2], dims[3], dims[4], dims[5], dims[6], dims[7], dims[8], dims[9], dims[10]};
  d.nb = dims[11];
  d.stationary = dims[12];
  const int smem = dims[13], wbytes = dims[14], slots = dims[15], umax = dims[16];
  const int ngmax = dims[17];
  const Widths& w = d.w;
  if (w.classes < 1 || w.classes > 32 || w.rows * w.classes != w.Z || d.N < 1 || d.T < 1 ||
      d.nb < 1 || slots != ring_slots(w) || umax < cdiv(w.H, d.nb)) {
    return (int)cudaErrorInvalidValue;
  }
  d.at = regions(w, wbytes, umax, ngmax, d.stationary != 0);
  if (smem != d.at.end || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  d.tail = gi_tail(w);
  d.lnp_stride = slots * kKC;
  d.K_a0 = (w.H + w.Z + 7) / 8 * 8;
  d.K_a1 = (w.AH1 + 7) / 8 * 8;
  d.K_head = (w.AH2 + 7) / 8 * 8;
  d.K_gi = (w.Z + w.A + 7) / 8 * 8;
  d.K_gh = (w.H + 7) / 8 * 8;
  d.K_d0 = d.K_gh;
  d.K_d1 = (w.DH1 + 7) / 8 * 8;
  d.K_d2 = (w.DH2 + 7) / 8 * 8;
  d.H16 = r16(w.H);
  d.Zf = w.Z / 16 * 16;
  d.ldx = d.H16 + r16(w.Z);
  d.ld_a0 = r16(w.AH1);
  d.ld_a1 = r16(w.AH2);
  d.ld_d0 = r16(w.DH1);
  d.ld_d1 = r16(w.DH2);
  d.keep = (float)(1.0 - (double)unimix);
  d.mix = (float)((double)unimix / w.classes);
  d.min_std = min_std;

  Operands o;
  int i = 0;
  auto wt = [&](void) { return static_cast<const bf16*>(ptrs[i++]); };
  auto f = [&](void) { return static_cast<const float*>(ptrs[i++]); };
  auto out = [&](void) { return static_cast<float*>(const_cast<void*>(ptrs[i++])); };
  auto buf = [&](void) { return static_cast<bf16*>(const_cast<void*>(ptrs[i++])); };
  o.a0w = wt(); o.a0b = f(); o.al0s = f(); o.al0b = f();
  o.a1w = wt(); o.a1b = f(); o.al1s = f(); o.al1b = f();
  o.muw = wt(); o.mub = f(); o.sgw = wt(); o.sgb = f();
  o.wi = wt(); o.wh = wt(); o.bi = f(); o.bh = f();
  o.d0w = wt(); o.d0b = f(); o.dl0s = f(); o.dl0b = f();
  o.d1w = wt(); o.d1b = f(); o.dl1s = f(); o.dl1b = f();
  o.d2w = wt(); o.d2b = f();
  o.h0 = f(); o.z0 = f(); o.eps = f(); o.gum = f();
  o.h_seq = out(); o.z_seq = out(); o.a_seq = out(); o.mu_seq = out(); o.sig_seq = out();
  o.h_fin = out(); o.z_fin = out();
  o.count = static_cast<unsigned*>(const_cast<void*>(ptrs[i++]));
  o.xs = buf(); o.ya0 = buf(); o.ya1 = buf(); o.yd0 = buf(); o.yd1 = buf();
  o.gh = out(); o.giz = out();
  o.table = static_cast<const int*>(ptrs[i++]);

  cudaError_t err = cudaFuncSetAttribute(imagine_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, imagine_kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm * sms < d.nb) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(o.count, 0, (1 + d.nb) * sizeof(unsigned), s)) != cudaSuccess)
    return (int)err;
  void* args[] = {&d, &o};
  return (int)cudaLaunchCooperativeKernel((const void*)imagine_kernel, dim3(d.nb), dim3(kThreads),
                                          args, (size_t)smem, s);
}
