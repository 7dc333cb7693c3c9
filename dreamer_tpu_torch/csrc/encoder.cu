// The world model's conv encoder on the tensor cores: uint8 frames to flat
// features.
//
// Replaces: dreamer_tpu/ops/conv_pallas.py, encoder_forward (kernels
// _encoder_kernel and _conv_k4s2p1).
//
//   x = norm[u8], a 256-entry bf16 table of the normalised pixel value
//   4 x [conv k4 / s2 / p1 + bias, SiLU], channels 3 -> c1 -> c2 -> c3 -> c4
//   out = x flattened in (h, w, c) order, bf16
//
// The table is an operand because the paths normalise differently: serving
// rounds u / 255 - 0.5 to bf16 once, as the TPU kernel does; the training
// paths round u / 255 and then the difference, as the JAX package's losses
// compute it in bf16 (ops/conv_cuda.py norm_table).  Products are bf16 x bf16
// summed in f32; bias and SiLU are applied in f32 and each layer's output is
// rounded to bf16 once, as in _conv_k4s2p1.
//
// What bounds it on an H100: operations.  A 64x64x3 frame at the flagship
// widths (32, 64, 128, 256) costs 53.5 MFLOP and moves 12 KB in and 8 KB out,
// some 2,600 FLOP per byte, far above the card's 295 FLOP/B balance point;
// at 1500 frames the bound is 0.081 ms of bf16 tensor-core time.
//
// Design: each layer is an implicit GEMM, out[M = pixels, N = channels] =
// A[M, K] . W[K, N] with K = 16 taps x Cin ordered (ky, kx, ci), run by one
// launch of encoder_conv_kernel: four launches a call.  The intermediates go
// through device memory as bf16 NHWC, their channels padded with zeros to a
// multiple of 16 (to 4 below 5): 0.17 GB written and read at 1500 frames.
// A block owns BM output pixels (part of one frame, or G whole frames in the
// late layers, where a frame has only 64 or 16) and BN channels:
// - the block's input rows (its activation tile) are copied into shared
//   memory once with cp.async, and A is gathered from that tile by the
//   ldmatrix addresses: the im2col exists only as addressing.  A 16-byte
//   chunk holds 8 channels of one pixel; a tap that falls in the zero
//   padding reads a zeroed block.  The chunks are XOR-swizzled by their
//   128-byte line and row pair, so that the 8 pixels one ldmatrix reads,
//   neighbours at stride 2 in the input, hit 8 different bank groups; the
//   key depends on the pixel only, so the K loop (taps outer) computes each
//   lane's offset once per tap and XORs the channel chunk in at each step.
//   Layer 0 stages its uint8 rows with cp.async and converts them through
//   the table to 4 channels (the 4th zero), with a zero column on either
//   side: one k16 step is then one kernel row (4 taps x 4 channels), two
//   16-byte chunks of 2 neighbouring pixels each.
// - the weights (HWIO, read as they are) stream through a 3-slot cp.async
//   ring of K-chunks of at most 16 KB: each weight reaches shared memory
//   once per block, the chunk after next loading under the MMAs.
// - 8 warps each own an (MT x 16) x (NT x 8) tile of f32 accumulators fed
//   by mma.sync.m16n8k16 (bf16 in, f32 sum).  The epilogue adds the bias and
//   applies SiLU in registers, rounds to bf16 into a tile in shared memory
//   and stores its rows as 16-byte chunks.
// The host (ops/conv_cuda.py encoder_plan) picks MT, NT, the warps' split
// and G per layer: large tiles when there are enough frames to fill the
// card (at 1500 frames 3000, 1500, 750 and 375 blocks), small ones when
// there are not, so that at N = 1 a frame is spread over 8 to 32 blocks in
// each layer.  Channel counts that are not a multiple of the tile get zero
// weights in shared memory; outputs past the stored channels are dropped.
// What still holds it back (PERF.md): per block, the loads, the MMAs and
// the epilogue run one after another with two blocks per SM to overlap
// them, and layer 3 reads its 1 MB of weights once per 4 frames from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 3;     // weight K-chunks in flight
constexpr int kLutBytes = 512;
constexpr int kSmemLimit = 232448;
constexpr int kPlanFields = 8;  // mt, nt, wn, bn, g, kc, blocks, smem

struct Layer {
  const void* x;                 // (N, H, W, Cs) bf16, or (N, H, W, 3) uint8 (u8)
  const __nv_bfloat16* norm;     // (256,) bf16, u8 input only
  const __nv_bfloat16* w;        // HWIO (4, 4, C, Co) bf16
  const float* b;                // (Co,) f32
  __nv_bfloat16* y;              // (N, H/2, W/2, Cso) bf16
  int u8;                        // input is uint8 frames through norm (C = 3)
  int N, H, W, C, Cs, Co, Cso;   // frames; input size, channels and their pitch; output
  int G, BM, BN, NB, KC, nkc;    // frames per block (1: part of one frame), tile, K-chunk
  int WN, TR, RP, PPF;           // warps along N; act tile rows and row pitch (chunks);
                                 // blocks per frame (G == 1)
  int Ps, lgPs, sA, NBP, sB;     // act chunks per pixel (a power of two), B row pitch
                                 // (chunks), swizzle shifts
  int ZB;                        // zero block bytes
};

// Bytes of the region that holds the act tile, then the epilogue's (BM,
// BN + 8) output tile; a multiple of a pixel's chunks, so that the zero
// block after the weight ring is aligned to them.
__host__ __device__ inline size_t act_region(const Layer& L) {
  const size_t a = (size_t)L.G * L.TR * L.RP * 16, t = (size_t)L.BM * (L.BN + 8) * 2;
  const size_t q = 16 * (size_t)L.Ps;
  return ((a > t ? a : t) + q - 1) / q * q;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r0, uint32_t* r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0[0]), "=r"(r0[1]), "=r"(r1[0]), "=r"(r1[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Swizzles.  ldmatrix reads 8 rows of 16 bytes at once; rows whose chunks
// share bits 4-6 of their address share banks.  Chunk ch of input pixel x in
// act tile row r sits at x * Ps + ch with its low three bits XORed by a key
// made of the pixel's 128-byte line (shifted by sA so that neighbours two
// pixels apart differ) and the row pair: the 8 output pixels of an ldmatrix
// (8 neighbours in a row, or 2 rows of 4) read 8 different bank groups.
// The key does not depend on ch, so a step XORs ch into the tap's offset.
__device__ __forceinline__ int act_chunk(const Layer& p, int x, int r) {
  const int key = ((((x << p.lgPs) >> 3) >> p.sA) + ((r >> 1) << 2)) & 7;
  return (x << p.lgPs) ^ key;
}

// Chunk n8 of weight row k in a ring slot: the low bits XORed by the row.
__device__ __forceinline__ int w_chunk(const Layer& p, int k, int n8) {
  const int L = k * p.NBP + n8;
  return L ^ (((L >> 3) >> p.sB) & 7);
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

__device__ __forceinline__ float bias_at(const Layer& p, int n) {
  return n < p.Co ? __ldg(p.b + n) : 0.0f;
}

// Output pixel m of the block -> frame offset g and pixel pp within the
// frame; false for rows past the block's frames or pixels.
__device__ __forceinline__ bool block_pixel(const Layer& p, int p0, int HWo, int m, int& g,
                                            int& pp) {
  if (p.G > 1) {
    g = m / HWo;
    pp = m - g * HWo;
    return g < p.G;
  }
  g = 0;
  pp = p0 + m;
  return pp < HWo;
}

// Starts the copies of input rows [r0, r0 + nrows) of frames [f0, f0 + G)
// into the activation tile; frames past N are zero-filled.  uint8 frames go
// to the staging area as they are, for convert_u8.  Warps take rows, lanes
// the chunks of a row.
__device__ void load_act(const Layer& p, unsigned char* act, unsigned char* stage, int f0,
                         int r0, int nrows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrow = p.G * nrows;
  for (int row = warp; row < nrow; row += kThreads / 32) {
    const int g = row / nrows, r = row - g * nrows, f = f0 + g;
    const bool in = f < p.N;
    const size_t pix0 = ((size_t)f * p.H + r0 + r) * p.W;  // the row's first pixel
    if (p.u8) {
      const uint32_t dst = smem_u32(stage) + (g * p.TR + r) * p.W * 3;
      const uint8_t* src = static_cast<const uint8_t*>(p.x) + pix0 * 3;
      for (int c = lane; c < p.W * 3 / 16; c += 32)
        cp_async16(dst + c * 16, in ? src + c * 16 : p.x, in ? 16 : 0);
    } else if (p.Cs == 4) {
      // Pixel x at 8-byte slot x + 1 of its row; slots 0 and W + 1 are zero.
      const uint32_t dst = smem_u32(act) + (g * p.TR + r) * p.RP * 16;
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.x) + pix0 * 4;
      for (int x = lane; x < p.W; x += 32)
        cp_async8(dst + (x + 1) * 8, in ? src + x * 4 : p.x, in ? 8 : 0);
    } else {
      const uint32_t dst = smem_u32(act) + (g * p.TR + r) * p.RP * 16;
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.x) + pix0 * p.Cs;
      const int pk = p.Cs >> 3;
      for (int L = lane; L < (p.W << p.lgPs); L += 32) {
        const int x = L >> p.lgPs, ch = L & (p.Ps - 1);
        if (ch < pk)
          cp_async16(dst + (act_chunk(p, x, r) ^ ch) * 16, in ? src + x * p.Cs + ch * 8 : p.x,
                     in ? 16 : 0);
      }
    }
    if (p.Cs == 4) {
      uint2* a8 = reinterpret_cast<uint2*>(act + (size_t)(g * p.TR + r) * p.RP * 16);
      if (lane == 0) a8[0] = make_uint2(0u, 0u);
      if (lane == 1) a8[p.W + 1] = make_uint2(0u, 0u);
    }
  }
}

// uint8 pixels in the staging area -> their 4 bf16 (the 4th zero) through
// the table, at 8-byte slot x + 1 of their act tile row.
__device__ void convert_u8(const Layer& p, unsigned char* act, const unsigned char* stage,
                           const __nv_bfloat16* lut, int nrows) {
  const int total = p.G * nrows * p.W;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int row = i / p.W, x = i - row * p.W;
    const int g = row / nrows, r = row - g * nrows;
    const unsigned char* px = stage + ((g * p.TR + r) * p.W + x) * 3;
    __nv_bfloat162 lo, hi;
    lo.x = lut[px[0]];
    lo.y = lut[px[1]];
    hi.x = lut[px[2]];
    hi.y = __float2bfloat16(0.0f);
    reinterpret_cast<uint2*>(act + (size_t)(g * p.TR + r) * p.RP * 16)[x + 1] =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
}

// K rows [kc * KC, kc * KC + KC) of the block's BN weight columns into ring
// slot `slot`.  Row k = tap * Cs + ci reads HWIO row tap * C + ci; rows
// ci >= C and columns n >= Co are zero.
__device__ void load_w(const Layer& p, unsigned char* wring, int kc, int slot, int n0) {
  const int nb8 = p.BN >> 3, lg = __ffs(nb8) - 1;
  const int total = p.KC * nb8, step = kThreads >> lg;  // rows advanced per pass
  const uint32_t base = smem_u32(wring) + slot * p.KC * p.NBP * 16;
  int kr = threadIdx.x >> lg;
  const int n8 = threadIdx.x & (nb8 - 1), n = n0 + n8 * 8;
  int k = kc * p.KC + kr, tap = k / p.Cs, ci = k - tap * p.Cs;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const uint32_t dst = base + w_chunk(p, kr, n8) * 16;
    const size_t row = (size_t)(tap * p.C + ci) * p.Co;
    if ((p.Co & 7) == 0) {
      const bool ok = ci < p.C && n < p.Co;
      cp_async16(dst, ok ? p.w + row + n : p.w, ok ? 16 : 0);
    } else {
      // Rows of Co bf16 are not 16-byte aligned: 8 plain loads.
      __align__(16) __nv_bfloat16 v[8];
      for (int e = 0; e < 8; ++e)
        v[e] = ci < p.C && n + e < p.Co ? p.w[row + n + e] : __float2bfloat16(0.0f);
      asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(dst),
                   "r"(reinterpret_cast<uint32_t*>(v)[0]), "r"(reinterpret_cast<uint32_t*>(v)[1]),
                   "r"(reinterpret_cast<uint32_t*>(v)[2]), "r"(reinterpret_cast<uint32_t*>(v)[3]));
    }
    kr += step;
    k += step;
    if (step >= p.Cs) {
      tap = k / p.Cs;
      ci = k - tap * p.Cs;
    } else if ((ci += step) >= p.Cs) {
      ci -= p.Cs;
      ++tap;
    }
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads) encoder_conv_kernel(const Layer p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Ho = p.H >> 1, Wo = p.W >> 1, HWo = Ho * Wo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / p.WN, wn = warp - wm * p.WN;
  const int nb = blockIdx.x % p.NB, mb = blockIdx.x / p.NB;
  const int n0 = nb * p.BN;
  int f0, p0;
  if (p.G > 1) {
    f0 = mb * p.G;
    p0 = 0;
  } else {
    f0 = mb / p.PPF;
    p0 = (mb - f0 * p.PPF) * p.BM;
  }
  // The input rows the block's output rows read.
  const int oy_lo = p0 / Wo;
  const int oy_hi = p.G > 1 ? Ho - 1 : min(HWo - 1, p0 + p.BM - 1) / Wo;
  const int r0 = max(0, 2 * oy_lo - 1), nrows = min(p.H, 2 * oy_hi + 3) - r0;

  // act tile | weight ring | zero block | table | uint8 staging
  unsigned char* act = smem;
  unsigned char* wring = act + act_region(p);
  unsigned char* zero = wring + (size_t)min(kStages, p.nkc) * p.KC * p.NBP * 16;
  __nv_bfloat16* lut = reinterpret_cast<__nv_bfloat16*>(zero + p.ZB);
  unsigned char* stage = zero + p.ZB + kLutBytes;

  for (int i = threadIdx.x; i < p.ZB / 16; i += kThreads)
    reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (p.u8)
    for (int i = threadIdx.x; i < 256; i += kThreads) lut[i] = p.norm[i];
  load_act(p, act, stage, f0, r0, nrows);
  load_w(p, wring, 0, 0, n0);
  cp_async_commit();
  if (p.nkc > 1) load_w(p, wring, 1, 1, n0);
  cp_async_commit();
  if (p.u8) {
    cp_async_wait0();
    __syncthreads();
    convert_u8(p, act, stage, lut, nrows);
  }

  // This lane's A rows: for each m16 tile, the tile row of tap ky = 0, the
  // input column of tap kx = 0 (the chunk of kx = 0, 1 for 4 channels) and
  // the frame's first row in the tile.
  int ay[MT], ax[MT], ag[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wm * MT + mt) * 16 + (lane & 15);
    int g, pp;
    if (block_pixel(p, p0, HWo, m, g, pp)) {
      const int oy = pp / Wo, ox = pp - oy * Wo;
      ay[mt] = 2 * oy - 1 - r0;
      ax[mt] = p.Cs == 4 ? ox : 2 * ox - 1;
    } else {
      ay[mt] = -4 * p.H;  // every tap out of range: the zero block
      ax[mt] = 0;
      g = 0;
    }
    ag[mt] = g * p.TR;
  }
  const int h = lane >> 4;  // this lane's k-half: 8 of the 16 k of a step
  const uint32_t act_u = smem_u32(act), zoff = (uint32_t)(zero - act);
  // Byte offsets of this lane's B rows and columns in a ring slot, step 0.
  uint32_t boff[(NT + 1) / 2];
  {
    const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      boff[np] = w_chunk(p, bk, wn * NT + 2 * np + (lane >> 4)) * 16;
    if (NT & 1) boff[NT / 2] = w_chunk(p, bk, wn * NT + NT - 1) * 16;
  }
  const uint32_t wring_u = smem_u32(wring);
  const uint32_t slot_bytes = p.KC * p.NBP * 16, step_bytes = 16 * p.NBP * 16;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // K in k16 steps: 16 taps of Cs/16 steps each, or for 4 channels 4
  // kernel rows of one step; a new weight slot every KC / 16 steps.
  const bool four = p.Cs == 4;
  const int taps = four ? 4 : 16, spt = four ? 1 : p.Cs >> 4, spk = p.KC >> 4;
  const uint32_t hx = four ? 0u : (uint32_t)h << 4;
  int s = 0;
  uint32_t wslot = wring_u;
  for (int t = 0; t < taps; ++t) {
    uint32_t aoff[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = ay[mt] + (four ? t : t >> 2);
      const int ix = ax[mt] + (four ? 0 : t & 3);
      const bool ok = (unsigned)(r + r0) < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
      const int row = (ag[mt] + r) * p.RP;
      aoff[mt] = ok ? (uint32_t)(row + (four ? ix + h : act_chunk(p, ix, r))) * 16 : zoff;
    }
    for (int c = 0; c < spt; ++c, ++s) {
      const int j = s & (spk - 1);
      if (j == 0) {  // a new weight K-chunk: wait for it, start the one after next
        const int kc = s / spk;
        cp_async_wait1();
        __syncthreads();
        if (kc + 2 < p.nkc) load_w(p, wring, kc + 2, (kc + 2) % kStages, n0);
        cp_async_commit();
        wslot = wring_u + (kc % kStages) * slot_bytes;
      }
      const uint32_t chx = ((uint32_t)c << 5) | hx;
      const uint32_t bstep = wslot + j * step_bytes;
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(act_u + (aoff[mt] ^ chx), a[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldsm_x4_t(bstep + boff[np], b[2 * np], b[2 * np + 1]);
      if (NT & 1) ldsm_x2_t(bstep + boff[NT / 2], b[NT - 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // Epilogue: + bias, SiLU in f32, one rounding to bf16 into a (BM, BN)
  // tile in shared memory (over the act tile, whose reads are done), then
  // 16-byte stores of its rows to NHWC.
  cp_async_wait0();
  __syncthreads();
  const int tp = p.BN + 8;  // tile row pitch (bf16): rows 16 bytes apart in banks
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = (wn * NT + nt) * 8 + (lane & 3) * 2;
    const float b0 = bias_at(p, n0 + col), b1 = bias_at(p, n0 + col + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (wm * MT + mt) * 16 + (lane >> 2) + hh * 8;
        *reinterpret_cast<__nv_bfloat162*>(tile + m * tp + col) = __floats2bfloat162_rn(
            silu(acc[mt][nt][2 * hh] + b0), silu(acc[mt][nt][2 * hh + 1] + b1));
      }
    }
  }
  __syncthreads();
  const int nw = min(p.BN, p.Cso - n0);  // columns this block stores
  if ((p.Cso & 7) == 0) {
    const int cpr = nw >> 3;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < p.BM * cpr; i += kThreads) {
      const int m = i / cpr, c = i - m * cpr;
      int g, pp;
      if (!block_pixel(p, p0, HWo, m, g, pp) || f0 + g >= p.N) continue;
      *reinterpret_cast<uint4*>(p.y + ((size_t)(f0 + g) * HWo + pp) * p.Cso + n0 + c * 8) =
          *reinterpret_cast<const uint4*>(tile + m * tp + c * 8);
    }
  } else {
    for (int i = threadIdx.x; i < p.BM * nw; i += kThreads) {
      const int m = i / nw, c = i - m * nw;
      int g, pp;
      if (!block_pixel(p, p0, HWo, m, g, pp) || f0 + g >= p.N) continue;
      p.y[((size_t)(f0 + g) * HWo + pp) * p.Cso + n0 + c] = tile[m * tp + c];
    }
  }
}

// Stored channels of an activation: 4 up to 4, else a multiple of 16.
int stored(int c) { return c <= 4 ? 4 : (c + 15) / 16 * 16; }

int log2i(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

// The rest of a layer from the host's choice (mt, nt, wn, bn, g, kc); the
// same arithmetic as ops/conv_cuda.py layer_plan, which checks it fits.
// Returns the dynamic shared memory the launch needs and sets `blocks`.
size_t complete(Layer& L, int mt, int wn, int& blocks) {
  const int Ho = L.H / 2, Wo = L.W / 2, HWo = Ho * Wo;
  L.Cs = stored(L.C);
  L.WN = wn;
  L.BM = (8 / wn) * mt * 16;
  L.NB = ((L.Cso + 7) / 8 * 8 + L.BN - 1) / L.BN;  // stored padding is written (zeros)
  L.nkc = 16 * L.Cs / L.KC;
  L.PPF = L.G > 1 ? 1 : (HWo + L.BM - 1) / L.BM;
  if (L.G > 1) {
    L.TR = L.H;
  } else {
    L.TR = 0;
    for (int q = 0; q < L.PPF; ++q) {
      const int lo = q * L.BM / Wo, hi = std::min(HWo - 1, q * L.BM + L.BM - 1) / Wo;
      L.TR = std::max(L.TR, std::min(L.H, 2 * hi + 3) - std::max(0, 2 * lo - 1));
    }
  }
  // A pixel's chunks padded to a power of two; rows of an ldmatrix are 2 Ps
  // chunks apart in the act tile, NBP (at least 4) in the weight slot: shift
  // the line index so that 8 such rows get 8 keys.
  L.Ps = 1;
  while (L.Ps < L.Cs / 8) L.Ps *= 2;
  L.lgPs = log2i(L.Ps);
  L.sA = L.Ps >= 8 ? L.lgPs - 2 : 0;
  L.NBP = std::max(4, L.BN / 8);
  L.sB = std::max(0, log2i(L.NBP) - 3);
  L.RP = L.Cs == 4 ? (L.W + 2) / 2 : (L.W * L.Ps + 7) / 8 * 8;
  L.ZB = std::max(16, L.Ps * 16);
  const size_t staging = L.u8 ? ((size_t)L.G * L.TR * L.W * 3 + 15) / 16 * 16 : 0;
  blocks = L.NB * (L.G > 1 ? (L.N + L.G - 1) / L.G : L.N * L.PPF);
  return act_region(L) + (size_t)std::min(kStages, L.nkc) * L.KC * L.NBP * 16 + L.ZB +
         kLutBytes + staging;
}

template <int MT, int NT>
cudaError_t launch(const Layer& L, int blocks, size_t smem, cudaStream_t stream) {
  static bool attributed = false;
  if (!attributed) {
    cudaError_t err = cudaFuncSetAttribute(
        encoder_conv_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    // All of L1 as shared memory, so that two blocks of up to 113 KB share an SM.
    err = cudaFuncSetAttribute(encoder_conv_kernel<MT, NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    attributed = true;
  }
  encoder_conv_kernel<MT, NT><<<blocks, kThreads, smem, stream>>>(L);
  return cudaGetLastError();
}

}  // namespace

// obs (N, H, W, 3) u8 with H, W multiples of 16; norm (256,) bf16; w_l (4, 4,
// C_l, C_l+1) bf16 (HWIO); b_l (C_l+1,) f32; out (N, H/16 * W/16 * c4) bf16;
// buf_a, buf_b bf16 scratch for the intermediates (layers 0 and 2 in buf_a,
// layer 1 in buf_b, channels padded as `stored`).  plan: 4 x kPlanFields
// ints from ops/conv_cuda.py encoder_plan.  Four launches; returns the first
// non-zero cudaGetLastError(), or cudaErrorInvalidValue for a plan that does
// not match these shapes.
extern "C" int dt_encoder_forward(const void* obs, const void* norm, const void* w0,
                                  const void* b0, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, void* out, void* buf_a, void* buf_b, int N,
                                  int H, int W, int c1, int c2, int c3, int c4, const int* plan,
                                  void* stream) {
  const void* ws[4] = {w0, w1, w2, w3};
  const void* bs[4] = {b0, b1, b2, b3};
  const int chans[5] = {3, c1, c2, c3, c4};
  const void* xs[4] = {obs, buf_a, buf_b, buf_a};
  void* ys[4] = {buf_a, buf_b, buf_a, out};
  for (int l = 0; l < 4; ++l) {
    const int* q = plan + l * kPlanFields;
    const int mt = q[0], nt = q[1], wn = q[2];
    Layer L;
    L.x = xs[l];
    L.norm = static_cast<const __nv_bfloat16*>(norm);
    L.w = static_cast<const __nv_bfloat16*>(ws[l]);
    L.b = static_cast<const float*>(bs[l]);
    L.y = static_cast<__nv_bfloat16*>(ys[l]);
    L.u8 = l == 0;
    L.N = N;
    L.H = H >> l;
    L.W = W >> l;
    L.C = chans[l];
    L.Co = chans[l + 1];
    L.Cso = l == 3 ? L.Co : stored(L.Co);
    L.BN = q[3];
    L.G = q[4];
    L.KC = q[5];
    int blocks = 0;
    const size_t smem = complete(L, mt, wn, blocks);
    if (wn < 1 || 8 % wn || (L.BN & (L.BN - 1)) || L.BN != wn * nt * 8 || L.KC % 16 ||
        (16 * L.Cs) % L.KC || (L.KC & (L.KC - 1)) || blocks != q[6] || smem != (size_t)q[7] || smem > kSmemLimit)
      return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (mt * 10 + nt) {
      case 11: err = launch<1, 1>(L, blocks, smem, s); break;
      case 12: err = launch<1, 2>(L, blocks, smem, s); break;
      case 14: err = launch<1, 4>(L, blocks, smem, s); break;
      case 21: err = launch<2, 1>(L, blocks, smem, s); break;
      case 22: err = launch<2, 2>(L, blocks, smem, s); break;
      case 24: err = launch<2, 4>(L, blocks, smem, s); break;
      case 41: err = launch<4, 1>(L, blocks, smem, s); break;
      case 42: err = launch<4, 2>(L, blocks, smem, s); break;
      case 44: err = launch<4, 4>(L, blocks, smem, s); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
