// The GRU step's tensor-core core, shared by gru_cell.cu and gru_scan.cu: one
// GEMM of the batch rows [x | h] against the gate weights, with the GRU's gate
// math fused into its epilogue.
//
// Arithmetic, the same in both kernels:
//   gx = x . Wi_{r,z,n}      bf16 products summed in f32 (mma.sync
//   gh = h_hi . Wh_{r,z,n}   m16n8k16), each from zero, over its K in k16
//   gl = h_lo . Wh_{r,z,n}   chunks in ascending order (scan only)
//   r  = sigmoid(((gx_r + gh_r) + b_ir) + b_hr)     gh = gh + gl in the scan
//   z  = sigmoid(((gx_z + gh_z) + b_iz) + b_hz)
//   hn = gh_n + b_hn
//   n  = tanh((gx_n + b_in) + r * hn)
//   h' = (1 - z) * n + z * h
// as _gate_math orders it (dreamer_tpu/ops/gru_pallas.py:36-55).  The scan
// carries h in f32 and multiplies it into the bf16 weights as two bf16
// halves, h_hi = bf16(h) and h_lo = bf16(h - h_hi), so that each product is
// exact to about 2^-17 of |h|.  On a bf16-valued h (the world-model path) h_lo
// is zero, gl is exactly zero, and gh + gl is gh: a T = 1 scan reproduces the
// cell bit for bit.
//
// The K schedule is fixed by (I, H) alone: the k16 chunks of x, then those
// of h (the last of each half filled with zeros in shared memory), each sum
// in one warp from zero.  Nothing in it depends on N, T or the tile plan, so
// an output's bits do not depend on which rows share its launch.  A plan
// (make_plan, mirrored by ops/gru_cuda.py gru_plan) picks only the row tiles
// and the column groups.
//
// A block owns bm rows and, at a time, one group of J hidden columns.  Its
// MMA warps split into two parts: the x part sums gx, the h part gh (and gl);
// inside a part, warps take MT m16 row tiles by 8 hidden columns, each warp
// holding three n8 accumulator tiles (the r, z and n gate rows of its 8
// columns) per m16 tile.  The weights keep gru_kernel_layout's (3H, Kp) rows,
// K contiguous, which is the .col B operand as it stands.  K streams through
// a ring of slots of 128 k of x and 64 of h each (x's K is 1.7 times h's at
// the flagship widths).  The batch rows come as the 16-byte chunks that hold
// them (x rows of an odd width start at any 2-byte address) and are
// converted one slot ahead into an A tile: shifted into place, zeroed past
// the row, and in the scan split into h_hi and h_lo.  Each row of a slot or
// tile has its 16-byte chunks XOR-swizzled by the row's low three bits, so
// that the 8 rows an ldmatrix reads hit 8 bank groups.  After the last slot
// the MMA warps write their accumulators to a tile of gate sums in shared
// memory, and threads apply the gate math to (row, column) pairs.
//
// Two block programs share this:
// - run_few, the few-rows plan (T = 1, N <= 64, the learner's 50 rows and
//   serving): 16 rows x 8 columns, 300 blocks at 50 rows, 3 an SM.  2 MMA
//   warps, and 6 copying warps that run ahead of them, handing over each
//   slot by named barriers.  The weights come by the TMA, 9 boxes of 8 rows
//   x 64 k a slot, swizzled as the tiles, zero past the matrix; the batch
//   rows by cp.async.  (cp.async for the weights too measured slower: the
//   SM's shared-memory pipe, shared with the ldmatrix, was the limit.)
// - run_block, every other plan: all 8 warps copy (cp.async), convert and
//   hold accumulators, one block barrier a slot.  At T > 1 a block owns 16
//   rows for all T steps and walks the column groups; each step reads the
//   state the last one wrote to h_seq, after a fence and a block barrier.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gru {

constexpr int kKCX = 128;           // k of x per ring slot: 8 k16 chunks, 256-byte rows
constexpr int kKCH = 64;            // k of h per ring slot: 4 k16 chunks, 128-byte rows
constexpr int kSmemLimit = 232448;  // the most shared memory a block may have
constexpr int kPlanFields = 11;
constexpr int kBigMT = 2;           // m16 tiles per warp when many rows share a step
constexpr int kThreads = 256;       // every plan: up to 8 MMA warps

struct Plan {
  int mt, rw, cw, stages;  // m16 tiles per warp; row and column warps per part; ring slots
  int bm, J;               // rows per block; hidden columns per column group
  int row_blocks, col_blocks, col_steps, threads, smem;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// k16 chunks of a half of K (the last one part zeros).
__host__ __device__ inline int chunks16(int K) { return (K + 15) / 16; }

// Staging chunks per row of a slot: its kc elements of `es` bytes from the
// aligned chunk holding the first one.
__host__ __device__ constexpr int stage_chunks(int kc, int es) { return kc * es / 16 + 1; }

// Ring slots: four for a scan's 16-row x 32-column tiles over T > 1 steps,
// three for the 32-row tiles and the few-rows plan (three of its blocks
// share an SM, and a shallower ring measured faster there).
__host__ __device__ constexpr int stages_for(int mt, int cw) { return mt == 1 && cw > 1 ? 4 : 3; }

// The launch for N rows (a scan's B) over T steps.  Many rows: 32-row x
// 32-column tiles; few: 16-row x 8-column tiles, so that the weight stream
// spreads over the SMs; a scan over T > 1 steps: one 16-row block per row
// tile for all T steps, walking 32-column groups.
inline Plan make_plan(int N, int T, int H, bool scan) {
  Plan p;
  if (T > 1) {
    p.mt = 1; p.rw = 1; p.cw = 4;
  } else if (N <= 64) {
    p.mt = 1; p.rw = 1; p.cw = 1;
  } else {
    p.mt = kBigMT; p.rw = 1; p.cw = 4;
  }
  p.stages = stages_for(p.mt, p.cw);
  p.bm = 16 * p.mt * p.rw;
  p.J = 8 * p.cw;
  const int groups = cdiv(H, p.J);
  p.row_blocks = cdiv(N, p.bm);
  p.col_blocks = T > 1 ? 1 : groups;
  p.col_steps = T > 1 ? groups : 1;
  p.threads = kThreads;
  const int gates = scan ? 9 : 6;
  const int staged = p.bm * 16 * (stage_chunks(kKCX, 2) + stage_chunks(kKCH, scan ? 4 : 2));
  const int tiles = 2 * p.bm * (kKCX + kKCH * (scan ? 2 : 1)) * 2;
  // The few-rows plan's weight boxes (3J rows of x's 128 k and of h's 64 k)
  // come first, 1024-byte aligned; its S mbarriers (64 bytes) last.
  const bool few = T == 1 && N <= 64;
  const int ring = few ? p.stages * (3 * p.J * (kKCX + kKCH) * 2 + staged) + tiles + 64
                       : p.stages * (3 * p.J * (kKCX + kKCH) * 2 + staged) + tiles;
  const int tile = p.bm * (gates * p.J + 4) * 4;
  // At T = 1 the gate tile reuses the slots once the one column group is done.
  p.smem = T > 1 ? ring + tile : (ring > tile ? ring : tile);
  return p;
}

inline void plan_fields(const Plan& p, int* out) {
  const int v[kPlanFields] = {p.mt, p.rw, p.cw, p.stages, p.bm, p.J, p.row_blocks,
                              p.col_blocks, p.col_steps, p.threads, p.smem};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
}

struct Gates {
  float out, r, z, n, hn;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Hidden column j's six biases.
struct Bias {
  float ir, iz, in, hr, hz, hn;
};

__device__ __forceinline__ Bias load_bias(const float* bi, const float* bh, int H, int j) {
  Bias b;
  b.ir = __ldg(bi + j);
  b.iz = __ldg(bi + H + j);
  b.in = __ldg(bi + 2 * H + j);
  b.hr = __ldg(bh + j);
  b.hz = __ldg(bh + H + j);
  b.hn = __ldg(bh + 2 * H + j);
  return b;
}

// The gate math on one (row, column): the six gate sums, the biases and h.
__device__ __forceinline__ Gates gate_math(float gx_r, float gx_z, float gx_n, float gh_r,
                                           float gh_z, float gh_n, const Bias& b, float h) {
  Gates g;
  g.r = sigmoid(((gx_r + gh_r) + b.ir) + b.hr);
  g.z = sigmoid(((gx_z + gh_z) + b.iz) + b.hz);
  g.hn = gh_n + b.hn;
  g.n = tanhf((gx_n + b.in) + g.r * g.hn);
  g.out = (1.0f - g.z) * g.n + g.z * h;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` < 16 fills the rest with
// zeros (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Named barriers: `n` threads (a multiple of 32) sync or arrive at `id`.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and the TMA, for the few-rows plan's weight boxes.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival at `bar`, announcing `bytes` more to land.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete; a load that
// never lands traps (an error, not a hang) after about two seconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// The box of `map` at (k, row) into shared memory at `dst` (1024-byte
// aligned for the 128-byte swizzle), landing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of 16-byte chunk c of row R of a slot or tile region whose
// rows are `pitch` bytes (128 or 256).
__device__ __forceinline__ uint32_t swz(int R, int c, int pitch) {
  return (uint32_t)(R * pitch + (c ^ (R & 7)) * 16);
}

// Eight bf16 row elements staged from byte `b` of `smem` on (b 2-byte
// aligned: rows of an odd width start at any 2-byte address), the elements
// from `nv` on zeroed (past the row).
__device__ __forceinline__ uint4 shift_bf16x8(const unsigned char* smem, int b, int nv) {
  uint32_t v[4];
  if ((b & 15) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(smem + b);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + (b & ~3));
    const int sh = (b & 3) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(w[i], w[i + 1], sh);
  }
  if (nv < 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (2 * i >= nv) v[i] = 0u;
      else if (2 * i + 1 >= nv) v[i] &= 0xffffu;
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Eight f32 row elements staged from byte `b` on (4-byte aligned), from `nv`
// on zero, split into the bf16 halves hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split_f32x8(const unsigned char* smem, int b, int nv, uint4& hi,
                                            uint4& lo) {
  const float* f = reinterpret_cast<const float*>(smem + b);
  float v[8];
  if ((b & 15) == 0 && nv >= 8) {
    const float4 p = reinterpret_cast<const float4*>(f)[0];
    const float4 q = reinterpret_cast<const float4*>(f)[1];
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < nv ? f[e] : 0.0f;
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    const float2 af = __bfloat1622float2(a);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * e] - af.x, v[2 * e + 1] - af.y);
    h[e] = *reinterpret_cast<const uint32_t*>(&a);
    l[e] = *reinterpret_cast<const uint32_t*>(&b);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// One k16 chunk kk of a slot for one warp: acc[mt][gate] += A . B for the
// warp's MT m16 tiles (rows arow0.. of A rows APITCH bytes, chunks from
// 2 kk0 on) and its 8 columns (rows brow0.. of each gate's J rows of B, rows
// KC * 2 bytes); with LO also lacc += A_lo . B.  Both swizzled (swz).
template <int MT, bool LO, int KC, int APITCH>
__device__ __forceinline__ void mma_k16(int kk, int kk0, uint32_t a_base, uint32_t lo_base,
                                        uint32_t b_base, int arow0, int brow0, int J, int lane,
                                        float (&acc)[MT][3][4], float (&lacc)[MT][3][4]) {
  uint32_t a[MT][4], l[MT][4], b[3][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int R = arow0 + mt * 16 + (lane & 15);
    const uint32_t off = swz(R, 2 * (kk0 + kk) + (lane >> 4), APITCH);
    ldsm_x4(a_base + off, a[mt]);
    if (LO) ldsm_x4(lo_base + off, l[mt]);
  }
  {
    // Matrices (r, k lo), (r, k hi), (z, k lo), (z, k hi); then (n, lo), (n, hi).
    const int m = lane >> 3;
    const int R = (m >> 1) * J + brow0 + (lane & 7);
    uint32_t q[4];
    ldsm_x4(b_base + swz(R, 2 * kk + (m & 1), KC * 2), q);
    b[0][0] = q[0]; b[0][1] = q[1]; b[1][0] = q[2]; b[1][1] = q[3];
    const int Rn = 2 * J + brow0 + (lane & 7);
    ldsm_x2(b_base + swz(Rn, 2 * kk + (m & 1), KC * 2), b[2]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      mma_bf16(acc[mt][g], a[mt], b[g]);
      if (LO) mma_bf16(lacc[mt][g], l[mt], b[g]);
    }
}

// A slot's k16 chunks [0, nk) in order (B rows of KC k); a whole slot as
// one straight run.
template <int MT, bool LO, int KC, int APITCH = KC * 2>
__device__ __forceinline__ void mma_slot(uint32_t a_base, uint32_t lo_base, uint32_t b_base,
                                         int nk, int arow0, int brow0, int J, int lane,
                                         float (&acc)[MT][3][4], float (&lacc)[MT][3][4],
                                         int kk0 = 0) {
  if (nk == KC / 16) {
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      mma_k16<MT, LO, KC, APITCH>(kk, kk0, a_base, lo_base, b_base, arow0, brow0, J, lane, acc,
                                  lacc);
  } else {
    for (int kk = 0; kk < nk; ++kk)
      mma_k16<MT, LO, KC, APITCH>(kk, kk0, a_base, lo_base, b_base, arow0, brow0, J, lane, acc,
                                  lacc);
  }
}

// A thread's copy of one weight chunk: row R = gate * J + c of the x (h)
// gates' B region, 16-byte chunk c16, read from gate row gate * H + group * J
// + c at k = 8 c16 + s KC.
struct WeightCopy {
  const unsigned char* src;  // at the launch's first column group, slot 0
  int col;                   // c: the column within the group
  int send, sfill;           // slots it copies; slots it zero-fills to
  int step, stride;          // bytes from one slot, one column group, to the next
  uint32_t dst;              // its place in a slot
};

// A thread's copy of one staging chunk of a batch row: from the 16-byte
// chunk holding the row's first element of the slot on, while that starts
// before the row's end.
struct RowCopy {
  uintptr_t src;  // at slot 0
  int send;       // slots it copies
  uint32_t dst;   // its place in a slot
};

// A thread's conversion of one A item: 8 elements of a row at chunk c.
struct Convert {
  int n;         // elements of the row from the item's first one, at slot 0
  int b;         // staging byte of its first element in a slot
  uint32_t off;  // its place in a tile (0xffffffff: none)
};

// The few-rows plan (T = 1, N <= 64: 16 rows, 8 hidden columns a block):
// 2 MMA warps (x part, h part) and 6 copying warps that run ahead of them.
// The weight rows come by the TMA: per ring step one thread loads 9 boxes
// of 8 rows x 64 k (the r, z, n rows of the block's 8 columns; x's 128 k as
// two boxes), swizzled 128 bytes as the A tiles, zero past the matrix,
// completing on the step's mbarrier.  The batch rows come by cp.async into
// staging and are converted into A tiles as in the other plans.  Hand-over
// by named barriers: FULL b (1, 2) when A tile b and its slot are ready,
// EMPTY b (3, 4) when the MMA warps are done with them; 5 syncs the copying
// warps, 6 the MMA warps.
template <class IO>
__device__ void run_few(const IO& io, const Plan& p, const CUtensorMap* twi,
                        const CUtensorMap* twh) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool LO = IO::kLo;
  constexpr int ESH = sizeof(typename IO::HT);
  constexpr int S = stages_for(1, 1), BM = 16, J = 8, NMMA = 64, NCOPY = kThreads - NMMA;
  constexpr int PX = kKCX * 2, PH = kKCH * 2;
  constexpr int BOX = J * 128;                 // one TMA box: 8 rows x 64 k
  constexpr int BSLOT = 9 * BOX;               // x: 2 halves x 3 gates; h: 3 gates
  constexpr int XW = stage_chunks(kKCX, 2) * 16, HW = stage_chunks(kKCH, ESH) * 16;
  constexpr int NXS = XW / 16, NHS = HW / 16, SSLOT = BM * (XW + HW);
  constexpr int TH = BM * PX, TL = TH + BM * PH, TILE = TL + (LO ? BM * PH : 0);
  constexpr int NG = LO ? 9 : 6, GP = NG * J + 4;
  constexpr int kFull = 1, kEmpty = 3, kCopiers = 5, kMma = 6;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* stage = smem + S * BSLOT;
  unsigned char* tiles = stage + S * SSLOT;
  const uint32_t bring = smem_u32(smem), sring = smem_u32(stage), tiles_u = smem_u32(tiles);
  const uint32_t bars = tiles_u + 2 * TILE;  // S mbarriers
  float* G = reinterpret_cast<float*>(smem);  // over the slots, at the end
  const int nsx = cdiv(io.Ip, kKCX), nsh = cdiv(io.Hp, kKCH);
  const int Q = nsx > nsh ? nsx : nsh;
  const int nchx = chunks16(io.Ip), nchh = chunks16(io.Hp);
  const int g0 = blockIdx.y, row0 = blockIdx.x * BM;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NMMA / 32) {
    const int ct = tid - NMMA;
    // This thread's staging chunks: x chunks (i < BM * NXS), then h chunks.
    constexpr int NST = cdiv(BM * (NXS + NHS), NCOPY);
    RowCopy rc[NST];
    bool rcx[NST];
#pragma unroll
    for (int u = 0; u < NST; ++u) {
      const int i = ct + u * NCOPY;
      const bool hp = i >= BM * NXS;
      const int ih = hp ? i - BM * NXS : i, nc = hp ? NHS : NXS;
      const int R = ih / nc, c = ih % nc, row = row0 + R;
      const bool ok = i < BM * (NXS + NHS) && row < io.N;
      const uintptr_t a = !ok ? 0
                          : hp ? reinterpret_cast<uintptr_t>(io.h_row(0, row))
                               : reinterpret_cast<uintptr_t>(io.x_row(0, row));
      rcx[u] = !hp;
      rc[u].src = (a & ~(uintptr_t)15) + 16 * c;
      rc[u].send = ok ? cdiv((int)(a + (uintptr_t)(hp ? io.H * ESH : io.I * 2) - rc[u].src),
                             hp ? kKCH * ESH : PX)
                      : 0;
      rc[u].dst = (hp ? BM * XW + R * HW : R * XW) + 16 * c;
    }
    // Ring step s: its weight boxes (thread 0) and its staged rows.
    auto issue = [&](int s, int slot) {
      if (ct == 0) {
        const uint32_t bar = bars + 8 * slot, base = bring + slot * BSLOT;
        mbar_arrive_tx(bar, (s < nsx ? 6 * BOX : 0) + (s < nsh ? 3 * BOX : 0));
        for (int g = 0; g < 3; ++g) {
          const int row = g * io.H + g0 * J;
          if (s < nsx) {
            tma_load_2d(base + g * BOX, twi, s * kKCX, row, bar);
            tma_load_2d(base + (3 + g) * BOX, twi, s * kKCX + 64, row, bar);
          }
          if (s < nsh) tma_load_2d(base + (6 + g) * BOX, twh, s * kKCH, row, bar);
        }
      }
      const uint32_t base = sring + slot * SSLOT;
#pragma unroll
      for (int u = 0; u < NST; ++u) {
        const bool part_on = rcx[u] ? s < nsx : s < nsh;
        if (part_on && s < rc[u].send)
          cp_async16(base + rc[u].dst,
                     reinterpret_cast<const void*>(rc[u].src +
                                                   (uintptr_t)s * (rcx[u] ? PX : kKCH * ESH)),
                     16);
      }
    };

    // This thread's conversions: 2 of the 16 x 16 x items and 16 x 8 h items.
    Convert cv[2];
    bool cvx[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = ct + u * NCOPY;
      const bool hp = i >= BM * 16;
      const int ih = hp ? i - BM * 16 : i, R = hp ? ih / 8 : ih / 16, c = hp ? ih % 8 : ih % 16;
      const int row = row0 + R;
      const bool ok = i < BM * 24 && row < io.N;
      const uintptr_t a = !ok ? 0
                          : hp ? reinterpret_cast<uintptr_t>(io.h_row(0, row))
                               : reinterpret_cast<uintptr_t>(io.x_row(0, row));
      cvx[u] = !hp;
      cv[u].n = ok ? (hp ? io.H : io.I) - 8 * c : 0;
      cv[u].b = hp ? BM * XW + R * HW + (int)(a & 15) + 8 * ESH * c
                   : R * XW + (int)(a & 15) + 16 * c;
      cv[u].off = i < BM * 24 ? (hp ? TH + swz(R, c, PH) : swz(R, c, PX)) : 0xffffffffu;
    }
    auto convert = [&](int s, int slot, int buf) {
      const unsigned char* st = stage + slot * SSLOT;
      unsigned char* tile = tiles + buf * TILE;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (cv[u].off == 0xffffffffu) continue;
        if (cvx[u]) {
          if (s >= nsx) continue;
          const int nv = cv[u].n - s * kKCX;
          *reinterpret_cast<uint4*>(tile + cv[u].off) = nv > 0 ? shift_bf16x8(st, cv[u].b, nv)
                                                               : zero;
        } else {
          if (s >= nsh) continue;
          const int nv = cv[u].n - s * kKCH;
          uint4 hi = zero, lo = zero;
          if (nv > 0) {
            if (LO)
              split_f32x8(st, cv[u].b, nv, hi, lo);
            else
              hi = shift_bf16x8(st, cv[u].b, nv);
          }
          *reinterpret_cast<uint4*>(tile + cv[u].off) = hi;
          if (LO) *reinterpret_cast<uint4*>(tile + cv[u].off + (TL - TH)) = lo;
        }
      }
    };

    for (int q = 0; q < S - 1; ++q) {
      if (q < Q) issue(q, q);
      cp_async_commit();
    }
    cp_async_wait<S - 2>();
    bar_sync(kCopiers, NCOPY);
    convert(0, 0, 0);
    bar_arrive(kFull, kThreads);
    for (int q = 0; q + 1 < Q; ++q) {  // ring step q + 1 into A tile (q + 1) % 2
      if (q >= 1) bar_sync(kEmpty + ((q + 1) & 1), kThreads);  // step q - 1 is done
      if (q + S - 1 < Q) issue(q + S - 1, (q + S - 1) % S);
      cp_async_commit();
      cp_async_wait<S - 2>();
      bar_sync(kCopiers, NCOPY);  // every copier's chunks of step q + 1 have landed
      convert(q + 1, (q + 1) % S, (q + 1) & 1);
      bar_arrive(kFull + ((q + 1) & 1), kThreads);
    }
    return;
  }

  // The MMA warps: warp 0 sums gx, warp 1 gh (and gl).  Each thread's two
  // (row, column) pairs of the gate math read their biases and h now, while
  // the first ring steps land.
  Bias bias[2];
  float hprev[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * NMMA, row = row0 + i / J, j = g0 * J + i % J;
    const bool ok = row < io.N && j < io.H;
    bias[u] = ok ? load_bias(io.bi, io.bh, io.H, j) : Bias{};
    hprev[u] = ok ? io.h_at(0, row, j) : 0.0f;
  }
  float acc[1][3][4], lacc[1][3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][g][e] = lacc[0][g][e] = 0.0f;
  for (int q = 0; q < Q; ++q) {
    const int slot = q % S;
    bar_sync(kFull + (q & 1), kThreads);
    mbar_wait(bars + 8 * slot, (q / S) & 1);  // the step's weight boxes
    const uint32_t a_base = tiles_u + (q & 1) * TILE, b_base = bring + slot * BSLOT;
    if (warp == 0) {
      if (q < nsx) {
        const int nk = nchx - 8 * q < 8 ? nchx - 8 * q : 8;
        // k16 chunks 0-3 from the first box of each gate, 4-7 from the second.
        mma_slot<1, false, kKCH, PX>(a_base, 0, b_base, nk < 4 ? nk : 4, 0, 0, J, lane, acc,
                                        lacc, 0);
        if (nk > 4)
          mma_slot<1, false, kKCH, PX>(a_base, 0, b_base + 3 * BOX, nk - 4, 0, 0, J, lane,
                                          acc, lacc, 4);
      }
    } else if (q < nsh) {
      const int nk = nchh - 4 * q < 4 ? nchh - 4 * q : 4;
      mma_slot<1, LO, kKCH, PH>(a_base + TH, a_base + TL, b_base + 6 * BOX, nk, 0, 0, J, lane,
                                   acc, lacc, 0);
    }
    if (q + 3 <= Q) bar_arrive(kEmpty + (q & 1), kThreads);
  }
  // The copiers are done with the slots; once both MMA warps are, the gate
  // tile goes over them.
  bar_sync(kMma, NMMA);
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int R = (lane >> 2) + 8 * (e >> 1), col = (lane & 3) * 2 + (e & 1);
      float* dst = G + R * GP + col;
      if (warp == 0) {
        dst[g * J] = acc[0][g][e];
      } else {
        dst[(3 + g) * J] = acc[0][g][e];
        if (LO) dst[(6 + g) * J] = lacc[0][g][e];
      }
    }
  bar_sync(kMma, NMMA);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = tid + u * NMMA, R = i / J, c = i % J, row = row0 + R, j = g0 * J + c;
    if (row >= io.N || j >= io.H) continue;
    const float* gs = G + R * GP + c;
    float gh_r = gs[3 * J], gh_z = gs[4 * J], gh_n = gs[5 * J];
    if (LO) {
      gh_r += gs[6 * J];
      gh_z += gs[7 * J];
      gh_n += gs[8 * J];
    }
    io.store(0, row, j, gate_math(gs[0], gs[J], gs[2 * J], gh_r, gh_z, gh_n, bias[u], hprev[u]));
  }
}

// The block's whole launch.  IO supplies the rows (x_row, h_row), h for the
// gate math (h_at), the stores (store), the operands and sizes, HT (the
// type of h) and kLo (the h_lo half).  Shared memory: S slots, each the
// weight rows of a (column group, k) step (3J rows of 256 bytes for x, 3J of
// 128 for h) and the staging chunks of its x and h rows; two A tiles (x rows
// of 256 bytes, h_hi and h_lo rows of 128), converted from the staging one
// step ahead; at T > 1 the gate tile after them (at T = 1 it reuses the
// slots).
template <int MT, int RW, int CW, class IO>
__device__ void run_block(const IO& io, const Plan& p, const CUtensorMap* twi,
                          const CUtensorMap* twh) {
  if constexpr (MT == 1 && RW == 1 && CW == 1) {
    run_few(io, p, twi, twh);
    return;
  } else {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool LO = IO::kLo;
  constexpr int ESH = sizeof(typename IO::HT);
  constexpr int S = stages_for(MT, CW);
  constexpr int BM = 16 * MT * RW, J = 8 * CW, WPP = RW * CW, MMA_WARPS = 2 * WPP;
  constexpr int NCOPY = kThreads;  // every warp copies
  constexpr int PX = kKCX * 2, PH = kKCH * 2;  // A and B row bytes: x, h
  constexpr int CX = PX / 16, CH = PH / 16;    // and their 16-byte chunks
  constexpr int NXS = stage_chunks(kKCX, 2), NHS = stage_chunks(kKCH, ESH);
  constexpr int NB = cdiv(3 * J * (CX + CH), NCOPY);  // per copying thread, per slot:
  constexpr int NSX = cdiv(BM * NXS, NCOPY);          // weight, x and h staging
  constexpr int NSH = cdiv(BM * NHS, NCOPY);          // chunks; x and h A items
  constexpr int NCX = cdiv(BM * CX, NCOPY), NCH = cdiv(BM * CH, NCOPY);
  constexpr int NG = LO ? 9 : 6, GP = NG * J + 4;
  constexpr int BX_BYTES = 3 * J * PX, B_BYTES = BX_BYTES + 3 * J * PH;
  constexpr int XS_BYTES = BM * NXS * 16;
  constexpr int SLOT = B_BYTES + XS_BYTES + BM * NHS * 16;
  constexpr int TH = BM * PX, TL = TH + BM * PH;  // tile: x, h_hi, h_lo rows
  constexpr int TILE = TL + (LO ? BM * PH : 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = warp / WPP;  // 0: x, 1: h
  const int wr = (warp % WPP) / CW, wc = warp % CW;
  unsigned char* tiles = smem + S * SLOT;
  float* G = reinterpret_cast<float*>(io.T > 1 ? tiles + 2 * TILE : smem);
  const uint32_t ring = smem_u32(smem), tiles_u = smem_u32(tiles);
  const int nsx = cdiv(io.Ip, kKCX), nsh = cdiv(io.Hp, kKCH);
  const int ns = nsx > nsh ? nsx : nsh;
  const int nchx = chunks16(io.Ip), nchh = chunks16(io.Hp);
  const int C = p.col_steps, Q = C * ns;  // ring steps per time step
  const int g0 = C > 1 ? 0 : blockIdx.y;  // the first column group
  const int row0 = blockIdx.x * BM, arow0 = wr * MT * 16;

  WeightCopy wcp[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int i = tid + u * NCOPY;
    const bool ok = i < 3 * J * (CX + CH);
    const bool hp = i >= 3 * J * CX;
    const int ih = i - 3 * J * CX;
    const int R = hp ? ih / CH : i / CX, c16 = hp ? ih % CH : i % CX;
    const int gate = R / J, c = R % J, K = hp ? io.Hp : io.Ip;
    const __nv_bfloat16* w = hp ? io.wh : io.wi;
    wcp[u].src = reinterpret_cast<const unsigned char*>(
        w + ((size_t)(gate * io.H + g0 * J + c) * K + 8 * c16));
    wcp[u].col = c;
    wcp[u].send = ok ? cdiv(K - 8 * c16, hp ? kKCH : kKCX) : 0;
    wcp[u].sfill = ok ? (hp ? nsh : nsx) : 0;
    wcp[u].step = hp ? PH : PX;
    wcp[u].stride = J * K * 2;
    wcp[u].dst = hp ? BX_BYTES + swz(R, c16, PH) : swz(R, c16, PX);
  }

  float acc[MT][3][4], lacc[MT][3][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][g][e] = lacc[mt][g][e] = 0.0f;

  for (int t = 0; t < io.T; ++t) {
    if (t > 0) {  // the last step's h' in h_seq, for every thread's copies
      __threadfence();
      __syncthreads();
    }
    // The step's row copies and conversions.
    RowCopy xcp[NSX], hcp[NSH];
    Convert cx[NCX], ch[NCH];
#pragma unroll
    for (int u = 0; u < NSX; ++u) {
      const int i = tid + u * NCOPY, R = i / NXS, c = i - R * NXS, row = row0 + R;
      const bool ok = i < BM * NXS && row < io.N;
      const uintptr_t a = ok ? reinterpret_cast<uintptr_t>(io.x_row(t, row)) : 0;
      xcp[u].src = (a & ~(uintptr_t)15) + 16 * c;
      xcp[u].send = ok ? cdiv((int)(a + (uintptr_t)io.I * 2 - xcp[u].src), PX) : 0;
      xcp[u].dst = B_BYTES + (R * NXS + c) * 16;
    }
#pragma unroll
    for (int u = 0; u < NSH; ++u) {
      const int i = tid + u * NCOPY, R = i / NHS, c = i - R * NHS, row = row0 + R;
      const bool ok = i < BM * NHS && row < io.N;
      const uintptr_t a = ok ? reinterpret_cast<uintptr_t>(io.h_row(t, row)) : 0;
      hcp[u].src = (a & ~(uintptr_t)15) + 16 * c;
      hcp[u].send = ok ? cdiv((int)(a + (uintptr_t)io.H * ESH - hcp[u].src), kKCH * ESH) : 0;
      hcp[u].dst = B_BYTES + XS_BYTES + (R * NHS + c) * 16;
    }
#pragma unroll
    for (int u = 0; u < NCX; ++u) {
      const int i = tid + u * NCOPY, R = i / CX, c = i % CX, row = row0 + R;
      const bool in = i < BM * CX, ok = in && row < io.N;
      const int d = ok ? (int)(reinterpret_cast<uintptr_t>(io.x_row(t, row)) & 15) : 0;
      cx[u].n = ok ? io.I - 8 * c : 0;
      cx[u].b = B_BYTES + R * NXS * 16 + d + 16 * c;
      cx[u].off = in ? swz(R, c, PX) : 0xffffffffu;
    }
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int i = tid + u * NCOPY, R = i / CH, c = i % CH, row = row0 + R;
      const bool in = i < BM * CH, ok = in && row < io.N;
      const int d = ok ? (int)(reinterpret_cast<uintptr_t>(io.h_row(t, row)) & 15) : 0;
      ch[u].n = ok ? io.H - 8 * c : 0;
      ch[u].b = B_BYTES + XS_BYTES + R * NHS * 16 + d + 8 * ESH * c;
      ch[u].off = in ? swz(R, c, PH) : 0xffffffffu;
    }

    // Ring step (s, column group grp) into slot `slot`: its weight rows and
    // its staged rows.  Rows past N and chunks past a row's end are not
    // copied: the conversion zeroes what they would hold.
    auto issue = [&](int s, int grp, int slot) {
      const uint32_t base = ring + slot * SLOT;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (s < wcp[u].send && grp * J + wcp[u].col < io.H)
          cp_async16(base + wcp[u].dst,
                     wcp[u].src + (size_t)s * wcp[u].step + (size_t)(grp - g0) * wcp[u].stride,
                     16);
        else if (s < wcp[u].sfill)
          cp_async16(base + wcp[u].dst, io.wi, 0);
      }
#pragma unroll
      for (int u = 0; u < NSX; ++u)
        if (s < xcp[u].send)
          cp_async16(base + xcp[u].dst,
                     reinterpret_cast<const void*>(xcp[u].src + (uintptr_t)s * PX), 16);
#pragma unroll
      for (int u = 0; u < NSH; ++u)
        if (s < hcp[u].send)
          cp_async16(base + hcp[u].dst,
                     reinterpret_cast<const void*>(hcp[u].src + (uintptr_t)s * kKCH * ESH), 16);
    };
    // Ring step s in slot `slot`: its staged rows into A tile `buf`.
    auto convert = [&](int s, int slot, int buf) {
      const unsigned char* st = smem + slot * SLOT;
      unsigned char* tile = tiles + buf * TILE;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      if (s < nsx) {
#pragma unroll
        for (int u = 0; u < NCX; ++u) {
          if (cx[u].off == 0xffffffffu) continue;
          const int nv = cx[u].n - s * kKCX;
          *reinterpret_cast<uint4*>(tile + cx[u].off) = nv > 0 ? shift_bf16x8(st, cx[u].b, nv)
                                                               : zero;
        }
      }
      if (s < nsh) {
#pragma unroll
        for (int u = 0; u < NCH; ++u) {
          if (ch[u].off == 0xffffffffu) continue;
          const int nv = ch[u].n - s * kKCH;
          uint4 hi = zero, lo = zero;
          if (nv > 0) {
            if (LO)
              split_f32x8(st, ch[u].b, nv, hi, lo);
            else
              hi = shift_bf16x8(st, ch[u].b, nv);
          }
          *reinterpret_cast<uint4*>(tile + TH + ch[u].off) = hi;
          if (LO) *reinterpret_cast<uint4*>(tile + TL + ch[u].off) = lo;
        }
      }
    };

    // Ring step (stage s, slot, A tile buf) for this warp's part.
    auto mma_step = [&](int s, int slot, int buf) {
      const uint32_t a_base = tiles_u + buf * TILE;
      const uint32_t bx = ring + slot * SLOT, bh = bx + BX_BYTES;
      if (part == 0) {
        if (s < nsx) {
          const int nk = nchx - 8 * s < 8 ? nchx - 8 * s : 8;
          mma_slot<MT, false, kKCX>(a_base, 0, bx, nk, arow0, wc * 8, J, lane, acc, lacc);
        }
      } else if (part == 1 && s < nsh) {
        const int nk = nchh - 4 * s < 4 ? nchh - 4 * s : 4;
        mma_slot<MT, LO, kKCH>(a_base + TH, a_base + TL, bh, nk, arow0, wc * 8, J, lane, acc,
                               lacc);
      }
    };
    // The MMA warps' accumulators into the gate tile, zeroed for the next
    // column group.
    auto gate_sums = [&]() {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int R = arow0 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
            const int col = wc * 8 + (lane & 3) * 2 + (e & 1);
            float* dst = G + R * GP + col;
            if (part == 0) {
              dst[g * J] = acc[mt][g][e];
            } else {
              dst[(3 + g) * J] = acc[mt][g][e];
              if (LO) dst[(6 + g) * J] = lacc[mt][g][e];
            }
            acc[mt][g][e] = lacc[mt][g][e] = 0.0f;
          }
    };
    // The gate math on column group grp's (row, column) pairs, by threads
    // first, first + count, ...
    auto gates_out = [&](int grp, int first, int count) {
      for (int i = tid - first; i < BM * J; i += count) {
        const int R = i / J, c = i % J, row = row0 + R, j = grp * J + c;
        if (row >= io.N || j >= io.H) continue;
        const float* gs = G + R * GP + c;
        float gh_r = gs[3 * J], gh_z = gs[4 * J], gh_n = gs[5 * J];
        if (LO) {
          gh_r += gs[6 * J];
          gh_z += gs[7 * J];
          gh_n += gs[8 * J];
        }
        io.store(t, row, j, gate_math(gs[0], gs[J], gs[2 * J], gh_r, gh_z, gh_n,
                                      load_bias(io.bi, io.bh, io.H, j), io.h_at(t, row, j)));
      }
    };

    // Cursors: the ring step to issue and the one to compute.
    int is = 0, ig = g0, islot = 0;
    for (int q = 0; q < S - 1; ++q) {
      if (q < Q) {
        issue(is, ig, islot);
        if (++is == ns) { is = 0; ++ig; }
        ++islot;
      }
      cp_async_commit();
    }
    cp_async_wait<S - 2>();
    __syncthreads();
    convert(0, 0, 0);

    int cs = 0, cg = g0, cslot = 0;
    for (int q = 0; q < Q; ++q) {
      cp_async_wait<S - 3>();  // ring step q + 1 has landed
      __syncthreads();         // and A tile q is converted
      const int nslot = cslot + 1 == S ? 0 : cslot + 1;
      if (q + S - 1 < Q) issue(is, ig, islot);
      cp_async_commit();
      if (q + 1 < Q) convert(cs + 1 == ns ? 0 : cs + 1, nslot, (q + 1) & 1);
      if (q + S - 1 < Q) {
        if (++is == ns) { is = 0; ++ig; }
        if (++islot == S) islot = 0;
      }
      mma_step(cs, cslot, q & 1);
      cslot = nslot;
      if (++cs < ns) continue;
      cs = 0;
      const int grp = cg++;

      // The column group's gate sums: accumulators to the gate tile (over the
      // slots at T = 1, whose copies must be done), then the gate math.
      if (io.T == 1) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (part < 2) gate_sums();
      __syncthreads();
      gates_out(grp, 0, kThreads);
    }
  }
  }
}

// Set once per kernel: the shared memory its largest plan needs, and all of
// L1 as shared memory so that several blocks share an SM.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The TMA map of a (3H, Kp) bf16 weight layout: boxes of 8 rows x 64 k,
// swizzled 128 bytes, zero past the matrix.  cuTensorMapEncodeTiled comes
// through cudaGetDriverEntryPoint, so that nothing links libcuda.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int rows, int kp) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * 2};
  const cuuint32_t box[2] = {64, 8}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The entry points' shape checks: widths padded to 8 as gru_kernel_layout
// pads them, and a plan that fits.
inline bool valid(int N, int T, int I, int H, int Ip, int Hp, const Plan& p) {
  return N >= 1 && T >= 1 && I >= 1 && H >= 1 && Ip == (I + 7) / 8 * 8 &&
         Hp == (H + 7) / 8 * 8 && p.smem <= kSmemLimit && p.col_blocks <= 65535;
}

}  // namespace gru
