"""The GRU kernels' shared tensor-core core (``csrc/gru_core.cuh``), on the
CPU: what its plan (``ops.gru_cuda.gru_plan``) launches and the arithmetic it
does.

- Every plan covers each (row, hidden column) of a launch exactly once, at
  the cell's and the scan's shapes, fits in a block's shared memory, and at
  the path's forms (the cell at 50 rows, the scan at T 1 x 1500) fills the
  132 SMs of an H100.
- The K schedule (the order in which every output sums its products) is one
  list for every N and T: the bits of an output do not depend on which rows
  share its launch, which the card's bit-for-bit checks (``hold_scan``,
  ``hold_observe``, the scan at T = 1 against the cell) rest on.
- The scan's f32 state goes in as two bf16 halves, h_hi = bf16(h) and
  h_lo = bf16(h - h_hi), each multiplied by the bf16 weights and summed in
  f32.  That arithmetic, emulated in torch, is held to ``gru_scan_plain`` at
  the flagship widths (T 30 x B 50) and to JAX's ``gru_scan_forward`` (the
  Pallas kernel in interpret mode, as tests/test_torch_gru_scan.py runs it)
  within ``gru_scan_cuda.TOL``; without h_lo it falls outside that tolerance,
  which is why the kernel carries both halves.
- The build key follows the header as it follows the sources.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamer_tpu.ops.gru_pallas import gru_scan_forward
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.ops import cuda_build, gru_cuda, gru_scan_cuda
from dreamer_tpu_torch.ops.gru_cuda import KC_H, KC_X, gru_kernel_layout, gru_plan, k_schedule
from dreamer_tpu_torch.ops.gru_scan_cuda import NAMES, gru_scan_plain

I, H = 1027, 600  # the flagship's GRU: [z (1024) | action (3)] in, 600 hidden
SMS = 132         # an H100's SMs

# (N, T) launches: the cell (T = 1) at serving's 1 and 64 envs, an odd
# count, the learner's 50 rows and hold_observe's 1500; the scan at the
# world-model path's T 1 x 1500, the flagship T 30 x B 50 and a small T 5 x 10.
CELL = [(1, 1), (3, 1), (50, 1), (64, 1), (1500, 1)]
SCAN = [(1500, 1), (50, 30), (10, 5)]
LAUNCHES = [(n, t, False) for n, t in CELL] + [(n, t, True) for n, t in SCAN + CELL]


def _covered(plan, n, t, h):
    """How often each (step, row, column) is written by the launch that
    ``plan`` describes, walked as ``run_block`` walks it: block (bx, by)
    owns rows bx * bm.. and, at each step, the column groups by (T = 1) or
    0..col_steps - 1 (T > 1); its epilogue covers bm x j pairs, dropping
    those past n or h."""
    count = np.zeros((t, n, h), dtype=np.int64)
    for bx in range(plan.row_blocks):
        rows = np.arange(bx * plan.bm, (bx + 1) * plan.bm)
        rows = rows[rows < n]
        for by in range(plan.col_blocks):
            for step in range(t):
                for c in range(plan.col_steps):
                    grp = c if plan.col_steps > 1 else by
                    cols = np.arange(grp * plan.j, (grp + 1) * plan.j)
                    cols = cols[cols < h]
                    count[step][np.ix_(rows, cols)] += 1
    return count


@pytest.mark.parametrize("n,t,scan", LAUNCHES)
def test_plan_covers_every_output_once(n, t, scan):
    plan = gru_plan(n, t, I, H, scan)
    assert (_covered(plan, n, t, H) == 1).all()
    # The MMA warps of a block: two parts (x, h) of rw x cw warps, each warp
    # mt m16 row tiles by 8 columns; the block's other warps only copy.
    assert 2 * plan.rw * plan.cw * 32 <= plan.threads == gru_cuda.THREADS
    assert plan.bm == 16 * plan.mt * plan.rw and plan.j == 8 * plan.cw
    # A block that carries a state owns its rows for every step.
    assert plan.col_blocks == 1 if t > 1 else plan.col_steps == 1


def round8(n):
    return -(-n // 8) * 8


def cdiv(a, b):
    return -(-a // b)


def plan_k_order(plan, t, i, h):
    """The chunks that ``run_block``'s slot loop hands to the x and the h
    warps of one block over its t steps and ``plan.col_steps`` column groups
    (a slot holds KC_X k of x and KC_H of h; a part's chunks stop at its
    padded width): one sequence per (step, column group), x's chunks then
    h's."""
    ip, hp = round8(i), round8(h)
    nsx, nsh = cdiv(ip, KC_X), cdiv(hp, KC_H)
    ns = max(nsx, nsh)
    px, ph = KC_X // 16, KC_H // 16
    orders, xs, hs = [], [], []
    for q in range(t * plan.col_steps * ns):
        s = q % ns
        if s < nsx:
            xs += [("x", 16 * c, 16 * c + 16)
                   for c in range(px * s, min(px * (s + 1), cdiv(ip, 16)))]
        if s < nsh:
            hs += [("h", 16 * c, 16 * c + 16)
                   for c in range(ph * s, min(ph * (s + 1), cdiv(hp, 16)))]
        if s == ns - 1:
            orders.append(tuple(xs + hs))
            xs, hs = [], []
    return tuple(orders)


@pytest.mark.parametrize("i,h", [(1027, 600), (37, 29), (13, 11), (67, 64)])
def test_k_schedule_is_the_same_for_every_plan(i, h):
    want = k_schedule(i, h)
    ip, hp = -(-i // 8) * 8, -(-h // 8) * 8
    # Whole k16 chunks of each part, the last reaching past the padded width.
    assert [c for c in want if c[0] == "x"][-1][2] >= ip > [c for c in want if c[0] == "x"][-1][1]
    assert [c for c in want if c[0] == "h"][-1][2] >= hp > [c for c in want if c[0] == "h"][-1][1]
    for n, t, scan in LAUNCHES:
        plan = gru_plan(n, t, i, h, scan)
        orders = plan_k_order(plan, t, i, h)
        assert len(orders) == t * plan.col_steps
        assert all(o == want for o in orders), (n, t, scan)


def test_plans_fit_and_fill_the_card():
    for n, t, scan in LAUNCHES:
        plan = gru_plan(n, t, I, H, scan)
        assert plan.smem <= gru_cuda.SMEM_LIMIT, (n, t, scan, plan)
    # The path's forms: the cell at the learner's 50 rows and the scan at
    # the world-model update's T 1 x 1500 spread over at least one wave.
    for n, t, scan in ((50, 1, False), (1500, 1, True), (1500, 1, False)):
        plan = gru_plan(n, t, I, H, scan)
        assert plan.row_blocks * plan.col_blocks >= SMS, (n, t, scan, plan)
    # The cell at the learner's 50 rows: every block resident at once, 3 an
    # SM (the card's 228 KB, 1 KB of it reserved per block).
    plan = gru_plan(50, 1, I, H)
    assert plan.row_blocks * plan.col_blocks <= 3 * SMS
    assert 3 * (plan.smem + 1024) <= 233472


def test_plan_constants_match_the_header():
    """The Python plan mirrors ``make_plan`` in the header: its constants
    and the tile choices it writes out."""
    src = (cuda_build.CSRC_DIR / "gru_core.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kKCX"]) == gru_cuda.KC_X and int(consts["kKCH"]) == gru_cuda.KC_H
    assert int(consts["kSmemLimit"]) == gru_cuda.SMEM_LIMIT
    assert int(consts["kBigMT"]) == gru_cuda.BIG_MT
    assert int(consts["kPlanFields"]) == len(gru_cuda.GruPlan._fields)
    assert int(consts["kThreads"]) == gru_cuda.THREADS
    choices = re.findall(r"p\.mt = (\w+); p\.rw = (\d+); p\.cw = (\d+);", src)
    want = [gru_plan(50, 30, I, H), gru_plan(50, 1, I, H), gru_plan(1500, 1, I, H)]
    assert [(gru_cuda.BIG_MT if m == "kBigMT" else int(m), int(r), int(c))
            for m, r, c in choices] == [(p.mt, p.rw, p.cw) for p in want]
    wide, other = re.search(r"stages_for\(int mt, int cw\) \{ return mt == 1 && cw > 1 \? "
                            r"(\d+) : (\d+); \}", src).groups()
    assert all(p.stages == int(wide if p.mt == 1 and p.cw > 1 else other) for p in want)


def split_scan(xs, h0, wi_t, wh_t, bi, bh, lo=True):
    """The core's arithmetic in torch: per step, x and the two bf16 halves of
    the f32 state each times the bf16 weights, summed in f32 (float32
    matmuls of bf16-valued operands: each product exact), then the gate
    math in ``gru_core.cuh``'s order.  ``lo=False`` drops the h_lo half."""
    I_, H_ = xs.shape[-1], h0.shape[-1]
    wi, wh = wi_t[:, :I_].float(), wh_t[:, :H_].float()
    bir, biz, bin_ = bi.float().split(H_)
    bhr, bhz, bhn = bh.float().split(H_)
    h = h0.float()
    seqs = [[] for _ in NAMES]
    for t in range(xs.shape[0]):
        hi = h.to(torch.bfloat16).float()
        gx_r, gx_z, gx_n = (xs[t].float() @ wi.t()).split(H_, -1)
        gh = hi @ wh.t()
        if lo:
            gh = gh + (h - hi).to(torch.bfloat16).float() @ wh.t()
        gh_r, gh_z, gh_n = gh.split(H_, -1)
        r = torch.sigmoid(((gx_r + gh_r) + bir) + bhr)
        z = torch.sigmoid(((gx_z + gh_z) + biz) + bhz)
        hn = gh_n + bhn
        n = torch.tanh((gx_n + bin_) + r * hn)
        h = (1.0 - z) * n + z * h
        for seq, v in zip(seqs, (h, r, z, n, hn)):
            seq.append(v)
    return tuple(torch.stack(s) for s in seqs)


def flagship_operands(t=30, b=50, seed=11):
    """The flagship GRU's bf16 kernel layout, bf16 x and an f32 state that
    is not bf16-valued (as the card tests' h0)."""
    g = torch.Generator().manual_seed(seed)
    ops = GRUCell(I, H, torch.bfloat16, g).kernel_weights()
    xs = torch.randn(t, b, I, generator=g).to(torch.bfloat16)
    h0 = torch.randn(b, H, generator=g).clamp(-1, 1)
    return xs, h0, ops


def test_split_arithmetic_matches_the_plain_scan_at_flagship_widths():
    xs, h0, ops = flagship_operands()
    stats = gru_scan_cuda.compare(split_scan(xs, h0, *ops), gru_scan_plain(xs, h0, *ops))
    assert stats["failures"] == [], stats
    # Far inside the tolerance: the halves keep each product to ~2^-17.
    assert max(stats[f"max_abs_err_{n}"] for n in NAMES) < 0.02 * gru_scan_cuda.TOL


def test_split_arithmetic_matches_jax_interpret():
    """Against the Pallas kernel's f32 arithmetic on bf16-valued x and
    weights (the kernel's operands) and an f32 h0."""
    rng = np.random.default_rng(0)
    t, b, i, h = 5, 10, 37, 29
    s = 1.0 / np.sqrt(h)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    xs = bf16(rng.standard_normal((t, b, i)))
    h0 = rng.standard_normal((b, h)).astype(np.float32)
    wi, wh = bf16(rng.uniform(-s, s, (i, 3 * h))), bf16(rng.uniform(-s, s, (h, 3 * h)))
    bi, bh = (bf16(rng.uniform(-s, s, 3 * h)) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        h_seq, res = gru_scan_forward(*(jnp.asarray(a) for a in (xs, h0, wi, wh, bi, bh)))
    ops = gru_kernel_layout(*(torch.from_numpy(a) for a in (wi, wh, bi, bh)), torch.bfloat16)
    out = split_scan(torch.from_numpy(xs).to(torch.bfloat16), torch.from_numpy(h0), *ops)
    stats = gru_scan_cuda.compare(out, tuple(torch.from_numpy(np.array(r))
                                             for r in (h_seq, *res)))
    assert stats["failures"] == [], stats


def test_without_the_lo_half_the_scan_leaves_its_tolerance():
    """h_hi alone rounds the state to bf16 in every product (2^-9 of |h|):
    at the flagship T 30 x B 50 that falls outside ``gru_scan_cuda.TOL``
    (measured: worst |diff| / tolerance 1.7, on hn and n), so the kernel
    carries h_lo; on a bf16-valued state (one step from a bf16 h0) the lo
    half is zero and both agree exactly."""
    xs, h0, ops = flagship_operands()
    ref = gru_scan_plain(xs, h0, *ops)
    stats = gru_scan_cuda.compare(split_scan(xs, h0, *ops, lo=False), ref)
    assert stats["failures"], stats
    h16 = h0.to(torch.bfloat16).float()
    one = [split_scan(xs[:1], h16, *ops, lo=lo) for lo in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*one))


def test_build_key_follows_the_header(tmp_path, monkeypatch):
    """An edit to the core's header must build a new library: the key hashes
    every file under csrc/, not only the .cu sources."""
    for f in cuda_build.files():
        (tmp_path / f.relative_to(cuda_build.CSRC_DIR)).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    key = cuda_build._digest()
    assert "gru_core.cuh" in [f.name for f in cuda_build.files()]
    assert "gru_core.cuh" not in [f.name for f in cuda_build.sources()]
    header = tmp_path / "gru_core.cuh"
    header.write_text(header.read_text() + "// changed\n")
    assert cuda_build._digest() != key
