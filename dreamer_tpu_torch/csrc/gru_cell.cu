// One GRU step with torch nn.GRUCell gate semantics, forward only, on the
// tensor cores.
//
// Replaces: dreamer_tpu/ops/gru_pallas.py, gru_cell_pallas / _forward_padded
// (kernel _gru_kernel, gate math _gate_math).  Serving needs no residuals (the
// TPU kernel's r, z, n, hn outputs feed only its backward), so none are kept.
//
//   r = sigmoid(x.W_ir + h.W_hr + b_ir + b_hr)
//   z = sigmoid(x.W_iz + h.W_hz + b_iz + b_hz)
//   n = tanh(x.W_in + b_in + r * (h.W_hn + b_hn))
//   out = (1 - z) * n + z * h
//
// Inputs are bf16; products are bf16 x bf16 summed in f32 on the tensor
// cores, the gate math runs in f32, and the output is rounded to bf16 once,
// as in _gate_math.
//
// What bounds it on an H100: the gate weights.  At the flagship shapes
// (x 1027 wide, h 600 wide, 3 gates of 600) one launch must read
// (1027 + 600) * 1800 * 2 B = 5.9 MB of weights, about 1.8 us at 3.35 TB/s,
// against 0.3 GFLOP for the 50 rows of a learner step (0.3 us at the bf16
// tensor-core rate); at 1500 rows the 8.8 GFLOP bound it (8.9 us).
//
// Design: the core in gru_core.cuh, shared with the whole-scan GRU (the h_lo
// half left out: h is bf16 here), so that a one-step scan on the same bf16
// state reproduces this kernel bit for bit.  Up to 64 rows (serving, the
// learner's 50) the few-rows plan: 16-row x 8-column blocks, 300 at 50 rows,
// the weights streamed by the TMA beside 2 MMA warps, so that the 5.9 MB
// spread over every SM; more rows (hold_observe's 1500) take 32 x 32 tiles.

#include "gru_core.cuh"

namespace {

struct CellIO {
  static constexpr bool kLo = false;
  using HT = __nv_bfloat16;
  const __nv_bfloat16* x;   // (N, I)
  const __nv_bfloat16* h;   // (N, H)
  const __nv_bfloat16* wi;  // (3H, Ip), rows r | z | n
  const __nv_bfloat16* wh;  // (3H, Hp), rows r | z | n
  const float* bi;          // (3H,)
  const float* bh;          // (3H,)
  __nv_bfloat16* out;       // (N, H)
  int N, T, I, H, Ip, Hp;

  __device__ const __nv_bfloat16* x_row(int, int row) const { return x + (size_t)row * I; }
  __device__ const __nv_bfloat16* h_row(int, int row) const { return h + (size_t)row * H; }
  __device__ float h_at(int, int row, int j) const {
    return __bfloat162float(h[(size_t)row * H + j]);
  }
  __device__ void store(int, int row, int j, const gru::Gates& g) const {
    out[(size_t)row * H + j] = __float2bfloat16(g.out);
  }
};

template <int MT, int RW, int CW>
__global__ void __launch_bounds__(gru::kThreads, MT == 1 && CW == 1 ? 3 : 1) gru_cell_kernel(const CellIO io, const gru::Plan p, const __grid_constant__ CUtensorMap twi,
                const __grid_constant__ CUtensorMap twh) {
  gru::run_block<MT, RW, CW>(io, p, &twi, &twh);
}

template <int MT, int RW, int CW>
cudaError_t launch(const CellIO& io, const gru::Plan& p, cudaStream_t stream) {
  // The few-rows plan loads its weight boxes by the TMA.
  CUtensorMap twi{}, twh{};
  if (MT == 1 && RW == 1 && CW == 1) {
    cudaError_t err = gru::weight_map(&twi, io.wi, 3 * io.H, io.Ip);
    if (err == cudaSuccess) err = gru::weight_map(&twh, io.wh, 3 * io.H, io.Hp);
    if (err != cudaSuccess) return err;
  }
  static bool attributed = false;
  if (!attributed) {
    const cudaError_t err = gru::allow_smem(gru_cell_kernel<MT, RW, CW>);
    if (err != cudaSuccess) return err;
    attributed = true;
  }
  gru_cell_kernel<MT, RW, CW><<<dim3(p.row_blocks, p.col_blocks), p.threads, p.smem, stream>>>(io, p, twi,
                                                                              twh);
  return cudaGetLastError();
}

}  // namespace

// The plan that the kernels launch for N rows over T steps, as kPlanFields
// ints (gru_core.cuh Plan, in order); scan != 0 for gru_scan_kernel.  The
// wrappers hold it against ops/gru_cuda.py gru_plan.
extern "C" int dt_gru_plan(int N, int T, int I, int H, int scan, int* out) {
  const gru::Plan p = gru::make_plan(N, T, H, scan != 0);
  gru::plan_fields(p, out);
  return gru::valid(N, T, I, H, (I + 7) / 8 * 8, (H + 7) / 8 * 8, p) ? 0
                                                                      : (int)cudaErrorInvalidValue;
}

// x (N, I), h (N, H), out (N, H) bf16; wi (3H, Ip), wh (3H, Hp) bf16 with
// Ip, Hp the widths rounded up to 8 and the padding zero, 16-byte aligned;
// bi, bh (3H,) f32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes it does not take.
extern "C" int dt_gru_cell_forward(const void* x, const void* h, const void* wi,
                                   const void* wh, const void* bi, const void* bh,
                                   void* out, int N, int I, int H, int Ip, int Hp,
                                   void* stream) {
  const gru::Plan p = gru::make_plan(N, 1, H, false);
  if (!gru::valid(N, 1, I, H, Ip, Hp, p)) return (int)cudaErrorInvalidValue;
  CellIO io;
  io.x = static_cast<const __nv_bfloat16*>(x);
  io.h = static_cast<const __nv_bfloat16*>(h);
  io.wi = static_cast<const __nv_bfloat16*>(wi);
  io.wh = static_cast<const __nv_bfloat16*>(wh);
  io.bi = static_cast<const float*>(bi);
  io.bh = static_cast<const float*>(bh);
  io.out = static_cast<__nv_bfloat16*>(out);
  io.N = N;
  io.T = 1;
  io.I = I;
  io.H = H;
  io.Ip = Ip;
  io.Hp = Hp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.mt == 1 && p.rw == 1 && p.cw == 1) return (int)launch<1, 1, 1>(io, p, s);
  if (p.mt == gru::kBigMT && p.rw == 1 && p.cw == 4) return (int)launch<gru::kBigMT, 1, 4>(io, p, s);
  return (int)cudaErrorInvalidValue;
}
