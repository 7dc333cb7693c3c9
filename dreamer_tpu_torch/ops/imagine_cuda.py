"""The whole-rollout imagination kernel (``csrc/imagine.cu``), its plain
PyTorch version, the kernel's weight layout, its launch plan and the check
that holds one against the other.

Replaces ``imagine_rollout_pallas`` (``dreamer_tpu/ops/imagine_pallas.py:281-348``,
kernel ``_imagine_kernel`` ``:181-279``): the H-step dream of an actor-critic
update, actor MLP -> tanh-Normal action -> GRU on [z ‖ a] -> dynamics-prior
MLP -> unimix, gumbel-argmax straight-through one-hot, every step.
``imagine_rollout`` launches the kernel for CUDA tensors (bf16 weights only,
at most 32 classes per latent row) and runs ``imagine_rollout_plain`` for
CPU tensors; it never falls back from one to the other.
``imagine_rollout.launches`` counts the kernel's launches.

Bound at the flagship shapes (B 50, T 30, GRU 600, 32x32 latents, hiddens
200): 11 GFLOP (2 B T x 3.66 M weights) and 24 MB (7.3 MB of bf16 weights,
9.8 MB of f32 outputs, 6.1 MB of gumbels), 0.011 ms at the card's bf16 peak.
The kernel is one persistent cooperative launch, one block on every SM, each
block holding its slice of every layer's output columns in shared memory for
all T steps, six stages a step with a grid barrier after each; its source
describes it.  ``imagine_plan`` gives each block its columns from the widths
and the block count alone, and the C source's own plan (``dt_imagine_plan``)
must equal it before a shape's first launch.

Both versions round where the Pallas kernel rounds, not where the XLA scan
does: a Dense accumulates in f32, rounds to the compute dtype and adds the
bias in that dtype; LayerNorm+SiLU and the GRU's gate math run in f32 and
round once; mu, sigma, the action and the sampling run in f32.  In float32
the two coincide with the XLA scan.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dreamer_tpu_torch.ops import cuda_build
from dreamer_tpu_torch.ops.gru_cuda import check_aligned

# The kernel against ``imagine_rollout_plain`` for one step, in bf16.  Both
# sum in f32 in another order and round each Dense output to bf16, so a sum
# near a rounding boundary moves by one bf16 step (2**-8 of |v|), which the
# LayerNorms and the next layers carry on: h' (|h'| < 1, itself in f32) and
# the actor's mu, sigma and action move by a few such steps.  Held to TOL abs
# + TOL relative, as the GRU cell is; a dropped LayerNorm bias moves them by
# far more (tests/test_torch_imagine.py).
TOL = 2e-2
# Sampled categories may differ only where the plain version's two best
# scores log p + gum lie within NEAR_TIE: the logits come out of a bf16 Dense
# (one step is 2**-8 of |logit|, 0.016 at 4) after two bf16 LayerNorm layers,
# so each score may move by a few hundredths.
NEAR_TIE = 0.1
# The straight-through value (onehot + p) - p keeps an f32 residual of about
# 2**-24 in the hot entry in about half of the rows; a kernel that computed
# onehot + (p - p) would return exact one-hots.  Of the rows that sampled the
# same category, the hot entries must agree to STE_ATOL, and at least
# MIN_RESIDUAL_SHARE of them must differ from 1.0.
STE_ATOL = 2.0 ** -22
MIN_RESIDUAL_SHARE = 0.1

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, ctypes.c_float, ctypes.c_float, _P]
N_WEIGHTS = 26
N_SCRATCH = 9  # the launch's record, x, four Dense outputs, two GRU sums, the plan
NAMES = ("h_fin", "z_fin", "h_seq", "z_seq", "a_seq", "mu_seq", "sig_seq")


def tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The largest |kernel - plain| allowed at each element of ``ref``, the
    plain version's h', mu, sigma or action."""
    return TOL + TOL * ref.float().abs()


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def dense_rows(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Dense weight (out, in) -> (out, round8(in)) in ``dtype``, zero padded:
    one contiguous row per output, read as 16-byte vectors."""
    out = torch.zeros(w.shape[0], _round8(w.shape[1]), dtype=dtype, device=w.device)
    out[:, :w.shape[1]] = w.to(dtype)
    return out


def layer_operands(params: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """The kernel's operands of a run of layers given as [W, b, (scale, bias)]*:
    each 2-D tensor is a Dense weight (out, in), made ``dense_rows``; the 1-D
    tensor after it is its bias, rounded to ``dtype`` (the Dense adds it in
    that dtype) and kept as float32; any other 1-D tensor is a LayerNorm scale
    or bias and stays float32."""
    out, prev_2d = [], False
    for p in params:
        if p.dim() == 2:
            out.append(dense_rows(p, dtype))
        elif prev_2d:
            out.append(p.to(dtype).float().contiguous())
        else:
            out.append(p.float().contiguous())
        prev_2d = p.dim() == 2
    return out


class Dims(NamedTuple):
    """The true sizes, read from the operands' shapes."""

    H: int
    Z: int
    A: int
    AH1: int
    AH2: int
    DH1: int
    DH2: int


def dims_of(weights: Sequence[torch.Tensor], h0: torch.Tensor, z0: torch.Tensor,
            eps: torch.Tensor) -> Dims:
    return Dims(H=h0.shape[-1], Z=z0.shape[-1], A=eps.shape[-1], AH1=weights[0].shape[0],
                AH2=weights[4].shape[0], DH1=weights[16].shape[0], DH2=weights[20].shape[0])


# --------------------------------------------------------------------------- #
# The plain version, one step at a time
# --------------------------------------------------------------------------- #


def _dense(x, w, b, dt, tap=None):
    """f32 accumulation, one rounding to ``dt``, then the bias added in ``dt``."""
    y = (x.float() @ w[:, :x.shape[-1]].float().t()).to(dt) + b.to(dt)
    return y if tap is None else y + tap


def _ln_silu(y, scale, bias, dt, tap=None, record=None):
    """LayerNorm (f32, fast variance, eps 1e-5) + SiLU in f32, rounded once.
    ``record`` (optional) receives the normalised input (y - mean) * rsqrt(var
    + 1e-5), from which the scale's gradient is taken."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = torch.clamp((yf * yf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rs = torch.rsqrt(var + 1e-5)
    if record is not None:
        record((yf - mean) * rs)
    out = (yf - mean) * (rs * scale) + bias
    if tap is not None:
        out = out + tap
    return F.silu(out).to(dt)


class Step(NamedTuple):
    h_next: torch.Tensor   # (N, H) f32
    z_next: torch.Tensor   # (N, Z) f32, the straight-through value
    action: torch.Tensor   # (N, A) f32
    mu: torch.Tensor
    sigma: torch.Tensor
    scores: torch.Tensor   # (N, rows, classes) f32: log p + gum


def imagine_step(weights: Sequence[torch.Tensor], h: torch.Tensor, z: torch.Tensor,
                 eps: torch.Tensor, gum: torch.Tensor, unimix: float, min_std: float,
                 taps: Optional[Dict[str, torch.Tensor]] = None,
                 acts: Optional[Dict[str, torch.Tensor]] = None) -> Step:
    """One imagination step on the kernel's operands, with the kernel's
    rounding points.  h (N, H), z (N, Z), eps (N, A), gum (N, rows, classes).

    ``taps`` (optional) are added at every Dense and LayerNorm output, named
    as in ``fused_scans._imagine_tap_shapes``; ``acts`` (optional) receives
    each Dense layer's input and each LayerNorm's normalised input, for the
    deferred weight gradients."""
    (a0w, a0b, al0s, al0b, a1w, a1b, al1s, al1b, muw, mub, sgw, sgb,
     wi, wh, bi, bh, d0w, d0b, dl0s, dl0b, d1w, d1b, dl1s, dl1b, d2w, d2b) = weights
    dt = a0w.dtype
    tap = (lambda k: taps.get(k)) if taps is not None else (lambda k: None)  # noqa: E731
    rec = acts.__setitem__ if acts is not None else (lambda k, v: None)  # noqa: E731

    def ln(k, pre, scale, bias):
        return _ln_silu(pre, scale, bias, dt, tap(k), lambda v: rec(k, v))

    H = h.shape[-1]

    xa = torch.cat([h, z], dim=-1).to(dt)
    rec("a.Dense_0", xa)
    pre = _dense(xa, a0w, a0b, dt, tap("a.Dense_0"))
    x = ln("a.LayerNorm_0", pre, al0s, al0b)
    rec("a.Dense_1", x)
    pre = _dense(x, a1w, a1b, dt, tap("a.Dense_1"))
    x = ln("a.LayerNorm_1", pre, al1s, al1b)
    rec("a.head_in", x)
    mu = _dense(x, muw, mub, dt, tap("a.mu_head")).float()
    sig_raw = _dense(x, sgw, sgb, dt, tap("a.log_sig_head")).float()
    sigma = F.softplus(torch.clamp(sig_raw, -5.0, 2.0)) + min_std
    action = torch.tanh(mu + sigma * eps)

    xg = torch.cat([z, action], dim=-1).to(dt)
    hg = h.to(dt)
    rec("g.i", xg)
    rec("g.h", hg)
    gi = _dense(xg, wi, bi, dt, tap("g.i")).float()
    gh = _dense(hg, wh, bh, dt, tap("g.h")).float()
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    zg = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    h_next = (1.0 - zg) * n + zg * h

    x = h_next.to(dt)
    rec("d.Dense_0", x)
    pre = _dense(x, d0w, d0b, dt, tap("d.Dense_0"))
    x = ln("d.LayerNorm_0", pre, dl0s, dl0b)
    rec("d.Dense_1", x)
    pre = _dense(x, d1w, d1b, dt, tap("d.Dense_1"))
    x = ln("d.LayerNorm_1", pre, dl1s, dl1b)
    rec("d.Dense_2", x)
    logits = _dense(x, d2w, d2b, dt, tap("d.Dense_2")).float()

    logits = logits.reshape(gum.shape)
    probs = (1.0 - unimix) * torch.softmax(logits, dim=-1) + unimix / gum.shape[-1]
    scores = torch.log(probs) + gum
    onehot = F.one_hot(torch.argmax(scores, dim=-1), gum.shape[-1]).float()
    z_next = ((onehot + probs) - probs.detach()).reshape(z.shape)
    return Step(h_next, z_next, action, mu, sigma, scores.detach())


@torch.no_grad()
def imagine_rollout_plain(h0, z0, eps, gum, weights, unimix: float, min_std: float):
    """The kernel's function step by step on the same operands: returns
    (h_fin, z_fin, h_seq, z_seq, a_seq, mu_seq, sig_seq), the sequences
    time-major with h_seq[t] the pre-step state."""
    h, z = h0.float(), z0.float()
    seqs = [[] for _ in range(5)]
    for t in range(eps.shape[0]):
        s = imagine_step(weights, h, z, eps[t], gum[t], unimix, min_std)
        for seq, v in zip(seqs, (h, z, s.action, s.mu, s.sigma)):
            seq.append(v)
        h, z = s.h_next, s.z_next
    return (h, z, *(torch.stack(seq) for seq in seqs))


# --------------------------------------------------------------------------- #
# The kernel's plan
# --------------------------------------------------------------------------- #

# Threads of every block; rows of a row group (four m16 tiles); k of a ring
# chunk; k slices (the warps that sum one output); n8 tiles of a pass; the most
# shared memory a block may have on an H100; the fixed shared-memory regions
# (a chunk of the activation ring and the fewest chunks it has, the logit
# tile, the LayerNorm statistics); the table's header, block and group
# records (csrc/imagine.cu).
THREADS = 512
ROWS = 64
KC = 128
SLICES = 4
MAX_NT = 5
SMEM_LIMIT = 232448
CHUNK_BYTES = ROWS * KC * 2
MIN_SLOTS = 4
STAT_BYTES = ROWS * 2 * 4
HEADER, BLOCK_FIELDS, GROUP_FIELDS = 8, 9, 4 + 3 * MAX_NT
# Grid barriers a step: after each of its six stages.  The last step's last
# one is left out and one comes before the first step, so a launch of T steps
# crosses 6 T.
BARRIERS_PER_STEP = 6
# The kinds of column tile, numbered as the C source's enum: S1 (actor
# Dense_0, the GRU's W_h and W_i's z rows), S2 (actor Dense_1), S4-S6 (the
# prior's three Dense layers, the last by latent row), S3 (the mu and sigma
# heads, in every block).
A0, WH, WI, A1, D0, D1, D2, HD = range(8)
KINDS = ("a0", "wh", "wi", "a1", "d0", "d1", "d2", "hd")


class Widths(NamedTuple):
    """The widths a plan depends on."""

    H: int
    Z: int
    rows: int
    classes: int
    A: int
    AH1: int
    AH2: int
    DH1: int
    DH2: int


def _r16(n: int) -> int:
    return (n + 15) // 16 * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def widths_of(d: Dims, rows: int, classes: int) -> Widths:
    return Widths(d.H, d.Z, rows, classes, d.A, d.AH1, d.AH2, d.DH1, d.DH2)


def k_range(w: Widths, kind: int) -> Tuple[int, int]:
    """The k range of a kind's products in its activation buffer: S1 and S4
    read x = [bf16 h, zeros to round16(H) | bf16 z, zeros to round16(Z)],
    the others a LayerNorm of a Dense output, zero past its width."""
    h16 = _r16(w.H)
    return {A0: (0, h16 + _r16(w.Z)), WH: (0, h16), D0: (0, h16),
            WI: (h16, h16 + w.Z // 16 * 16), A1: (0, _r16(w.AH1)), D1: (0, _r16(w.DH1)),
            D2: (0, _r16(w.DH2)), HD: (0, _r16(w.AH2))}[kind]


def tile_bytes(w: Widths, kind: int) -> int:
    """A tile in shared memory: 8 weight rows of its k range and 16 bytes,
    then its 8 columns' f32 biases."""
    k0, k1 = k_range(w, kind)
    return 8 * ((k1 - k0) * 2 + 16) + 32


def d2_tiles(w: Widths, lr: int) -> range:
    """The n8 tiles of the prior's output layer that hold latent row lr."""
    return range(lr * w.classes // 8, ((lr + 1) * w.classes - 1) // 8 + 1)


def ring_slots(w: Widths) -> int:
    """Ring chunks: a whole LayerNorm input row group, and after a pass the
    slice sums then the logits, at least MIN_SLOTS."""
    sums = SLICES * ROWS * MAX_NT * 8 * 4 + ROWS * max(MAX_NT * 8, 2 * w.A) * 4
    return max(MIN_SLOTS, _cdiv(max(w.AH1, w.AH2, w.DH1, w.DH2), KC), _cdiv(sums, CHUNK_BYTES))


def smem_bytes(w: Widths, weight_bytes: int, umax: int, ngmax: int, stationary: bool) -> int:
    """A block's shared memory: the weights, then the ring (which after a
    pass holds the slice sums and the logits), the LayerNorm statistics, its
    scale and bias, a row group's eps and W_i's tail inputs, and when the
    weights are resident b_i and W_i's tail rows of the block's GRU columns
    and the block's part of the plan's table."""
    tail = w.Z - w.Z // 16 * 16 + w.A
    slots = ring_slots(w)
    return ((weight_bytes + 127) // 128 * 128 + slots * CHUNK_BYTES
            + STAT_BYTES + 2 * slots * KC * 4
            + _r16(ROWS * (w.A + tail) * 4)
            + (_r16(3 * umax * (tail + 1) * 4) + _r16((BLOCK_FIELDS + ngmax * GROUP_FIELDS) * 4)
               if stationary else 0))


def k_schedule(w: Widths, kind: int) -> Tuple[Tuple[int, ...], ...]:
    """The order in which the kernel sums each output of a kind: for each k
    slice s, the k16 steps (their first k in the activation buffer) whose
    index is s mod SLICES, ascending; the slice sums are then added in slice
    order.  It depends on the widths alone."""
    k0, k1 = k_range(w, kind)
    return tuple(tuple(k for k in range(k0, k1, 16) if (k // 16) % SLICES == s)
                 for s in range(SLICES))


class Group(NamedTuple):
    """One pass: up to MAX_NT tiles over one k range."""

    tiles: Tuple[Tuple[int, int, int], ...]  # (kind, index, shared-memory offset)
    k0: int
    k1: int
    latent_row: int                          # S6: the latent row it samples; else -1


class ImaginePlan(NamedTuple):
    blocks: int
    stationary: bool    # every block's weights resident for all T steps
    smem: int           # bytes of dynamic shared memory of every block
    weight_bytes: int   # the weights' region: a block's all, or the largest group
    stages: Tuple[Tuple[Tuple[Group, ...], ...], ...]  # [block][S1 .. S6]
    gru: Tuple[Tuple[int, int], ...]                   # [block]: its GRU units [u0, u1)
    table: Tuple[int, ...]                             # as dt_imagine_plan writes it


def imagine_plan(w: Widths, blocks: int) -> ImaginePlan:
    """The kernel's launch over ``blocks`` blocks at widths ``w``: the same
    arithmetic as ``make_plan`` in ``csrc/imagine.cu``.  The GRU's hidden
    units split evenly (block b: [H b / nb, H (b + 1) / nb), its r, z and n
    columns packed into n8 tiles); every other layer's n8 tiles, and the
    prior output's latent rows, go one by one to the block holding the fewest
    weight bytes so far (the first on a tie); every block has the heads'
    tiles (S3).  A block's tiles of one stage form passes of MAX_NT (S6: one
    latent row a pass).  Stationary when every block's tiles fit in shared
    memory beside the fixed regions; else each pass copies its tiles into a
    window first, with fewer tiles a pass where MAX_NT would not fit."""
    nb = blocks
    if nb < 1 or min(w) < 1 or w.classes > 32 or w.rows * w.classes != w.Z:
        raise ValueError(f"imagine_plan: the kernel does not take widths {w} over {nb} blocks")
    zf = w.Z // 16 * 16
    gru_kinds = (WH, WI) if zf else (WH,)
    heads = _cdiv(2 * w.A, 8)
    gru = [(w.H * b // nb, w.H * (b + 1) // nb) for b in range(nb)]
    held = [_cdiv(3 * (u1 - u0), 8) * sum(tile_bytes(w, k) for k in gru_kinds)
            + heads * tile_bytes(w, HD) for u0, u1 in gru]
    own: Dict[Tuple[int, int], List[int]] = {}
    for kind, units in ((A0, _cdiv(w.AH1, 8)), (A1, _cdiv(w.AH2, 8)), (D0, _cdiv(w.DH1, 8)),
                        (D1, _cdiv(w.DH2, 8)), (D2, w.rows)):
        for i in range(units):
            best = min(range(nb), key=lambda b: (held[b], b))
            own.setdefault((kind, best), []).append(i)
            held[best] += (len(d2_tiles(w, i)) if kind == D2 else 1) * tile_bytes(w, kind)

    def build(cap):
        """[block][stage] -> [(tiles, latent row)], at most cap tiles a pass."""
        def passes(tiles):
            return [(tiles[s:s + cap], -1) for s in range(0, len(tiles), cap)]

        raw = []
        for b, (u0, u1) in enumerate(gru):
            gt = _cdiv(3 * (u1 - u0), 8)
            s1 = [(A0, i) for i in own.get((A0, b), [])] + [(k, j) for k in gru_kinds
                                                             for j in range(gt)]
            stages = [passes(s1)]
            for kind in (A1, HD, D0, D1):
                stages.append(passes([(HD, j) for j in range(heads)] if kind == HD
                                     else [(kind, i) for i in own.get((kind, b), [])]))
            stages.append([([(D2, i) for i in d2_tiles(w, lr)], lr)
                           for lr in own.get((D2, b), [])])
            raw.append(stages)
        return raw

    nbytes = lambda tiles: sum(tile_bytes(w, k) for k, _ in tiles)  # noqa: E731
    group_max = lambda raw: max([nbytes(t) for stages in raw for st in stages  # noqa: E731
                                 for t, _ in st] + [0])
    umax = max(u1 - u0 for u0, u1 in gru)
    ngmax = lambda raw: max(sum(len(st) for st in stages) for stages in raw)  # noqa: E731
    limit = SMEM_LIMIT
    cap = MAX_NT
    raw = build(cap)
    block_max = max(sum(nbytes(t) for st in stages for t, _ in st) for stages in raw)
    stationary = smem_bytes(w, block_max, umax, ngmax(raw), True) <= limit
    # Streamed: fewer tiles a pass until the largest pass's window fits.
    while (not stationary and smem_bytes(w, group_max(raw), umax, ngmax(raw), False) > limit
           and cap > 1):
        cap -= 1
        raw = build(cap)
    wbytes = block_max if stationary else group_max(raw)
    smem = smem_bytes(w, wbytes, umax, ngmax(raw), stationary)
    if smem > limit:
        raise ValueError(f"imagine_plan: a pass of widths {w} needs {smem} bytes of shared "
                         f"memory over {nb} blocks")
    plan_stages, groups = [], []
    for stages in raw:
        off, block = 0, []
        for st in stages:
            row = []
            for tiles, lr in st:
                off = off if stationary else 0
                placed = []
                for kind, i in tiles:
                    placed.append((kind, i, off))
                    off += tile_bytes(w, kind)
                ranges = [k_range(w, k) for k, _ in tiles]
                row.append(Group(tuple(placed), min(r[0] for r in ranges),
                                 max(r[1] for r in ranges), lr))
            block.append(tuple(row))
            groups.extend(row)
        plan_stages.append(tuple(block))
    table = [nb, int(stationary), smem, len(groups), wbytes, ring_slots(w), umax, ngmax(raw)]
    n = 0
    for block, (u0, u1) in zip(plan_stages, gru):
        firsts = []
        for st in block:
            firsts.append(n)
            n += len(st)
        table += [*firsts, n, u0, u1]
    for g in groups:
        table += [len(g.tiles), g.k0, g.k1, g.latent_row]
        for i in range(MAX_NT):
            table += list(g.tiles[i]) if i < len(g.tiles) else [0, 0, 0]
    return ImaginePlan(nb, stationary, smem, wbytes, tuple(plan_stages), tuple(gru),
                       tuple(table))


_plans: Dict[Tuple[Widths, int, int], Tuple[ImaginePlan, torch.Tensor]] = {}


def c_plan_table(w: Widths, blocks: int) -> Tuple[int, ...]:
    """The C source's plan table (``dt_imagine_plan``) for these widths."""
    fn = cuda_build.kernel_fn("dt_imagine_plan", [_P, _I, _P, _I, _P])
    cap = 1 << 16
    while True:
        out, n = (ctypes.c_int * cap)(), ctypes.c_int()
        cuda_build.check(fn((ctypes.c_int * 9)(*w), blocks, out, cap, ctypes.byref(n)),
                         "dt_imagine_plan")
        if n.value <= cap:
            return tuple(out[:n.value])
        cap = n.value


def checked_plan(w: Widths, blocks: int, device: torch.device
                 ) -> Tuple[ImaginePlan, torch.Tensor]:
    """``imagine_plan`` and its table on ``device``, held once per shape
    against the plan the C source builds (``dt_imagine_plan``): a kernel
    whose plan drifted from the Python one is refused."""
    key = (w, blocks, device.index)
    got = _plans.get(key)
    if got is None:
        plan = imagine_plan(w, blocks)
        table = c_plan_table(w, blocks)
        if table != plan.table:
            raise RuntimeError(f"imagine plan for {w} over {blocks} blocks: the C source's "
                               f"table differs from imagine_plan's")
        got = plan, torch.tensor(plan.table, dtype=torch.int32, device=device)
        _plans[key] = got
    return got


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------------- #


def _check(h0, z0, eps, gum, weights) -> None:
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"imagine_rollout: expects {N_WEIGHTS} weight operands, "
                         f"got {len(weights)}")
    if h0.dim() != 2 or z0.dim() != 2 or eps.dim() != 3 or gum.dim() != 4:
        raise ValueError("imagine_rollout: h0 (B, H), z0 (B, Z), eps (T, B, A) and gum "
                         "(T, B, rows, classes) expected")
    B, H = h0.shape
    Z = z0.shape[1]
    T, _, A = eps.shape
    rows, classes = gum.shape[2:]
    if z0.shape[0] != B or tuple(eps.shape[:2]) != (T, B) or tuple(gum.shape[:2]) != (T, B) \
            or rows * classes != Z:
        raise ValueError(f"imagine_rollout: shapes h0 {tuple(h0.shape)} z0 {tuple(z0.shape)} "
                         f"eps {tuple(eps.shape)} gum {tuple(gum.shape)} do not agree")
    d = dims_of(weights, h0, z0, eps)
    want = [(d.AH1, _round8(H + Z)), (d.AH1,), (d.AH1,), (d.AH1,),
            (d.AH2, _round8(d.AH1)), (d.AH2,), (d.AH2,), (d.AH2,),
            (A, _round8(d.AH2)), (A,), (A, _round8(d.AH2)), (A,),
            (3 * H, _round8(Z + A)), (3 * H, _round8(H)), (3 * H,), (3 * H,),
            (d.DH1, _round8(H)), (d.DH1,), (d.DH1,), (d.DH1,),
            (d.DH2, _round8(d.DH1)), (d.DH2,), (d.DH2,), (d.DH2,),
            (Z, _round8(d.DH2)), (Z,)]
    for i, (w, shape) in enumerate(zip(weights, want)):
        if tuple(w.shape) != shape:
            raise ValueError(f"imagine_rollout: weight operand {i} is {tuple(w.shape)}, "
                             f"expected {shape}")
        if w.dtype != (weights[0].dtype if len(shape) == 2 else torch.float32):
            raise TypeError(f"imagine_rollout: weight operand {i} has dtype {w.dtype}")
    for name, v in (("h0", h0), ("z0", z0), ("eps", eps), ("gum", gum)):
        if v.dtype != torch.float32:
            raise TypeError(f"imagine_rollout: {name} must be float32, got {v.dtype}")
    tensors = (h0, z0, eps, gum, *weights)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("imagine_rollout: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("imagine_rollout: operands must be contiguous")


def imagine_rollout(h0: torch.Tensor, z0: torch.Tensor, eps: torch.Tensor,
                    gum: torch.Tensor, weights: Sequence[torch.Tensor], unimix: float,
                    min_std: float):
    """The whole T-step imagination.  h0 (B, H), z0 (B, Z), eps (T, B, A) and
    gum (T, B, rows, classes) float32; ``weights`` the 26 operands of
    ``Actor.imagine_weights()`` and ``WMNets.imagine_weights()``.  Returns
    (h_fin, z_fin, h_seq, z_seq, a_seq, mu_seq, sig_seq), all float32."""
    _check(h0, z0, eps, gum, weights)
    if h0.device.type == "cpu":
        return imagine_rollout_plain(h0, z0, eps, gum, weights, unimix, min_std)
    return _launch(h0, z0, eps, gum, weights, unimix, min_std)[0]


def _launch(h0, z0, eps, gum, weights, unimix: float, min_std: float,
            blocks: Optional[int] = None):
    """The kernel over ``blocks`` blocks (one per SM unless given; the
    outputs do not depend on it), for operands ``_check`` passed.
    Returns the seven outputs and the launch's record, an int32 tensor on the
    card that ``launch_record`` reads."""
    rows, classes = gum.shape[2:]
    if h0.device.type != "cuda" or weights[0].dtype != torch.bfloat16 or classes > 32:
        raise TypeError(f"imagine_rollout: the kernel takes bfloat16 weights on CUDA and "
                        f"at most 32 classes, got {weights[0].dtype} on {h0.device} with "
                        f"{classes} classes")
    check_aligned("imagine_rollout", *(w for w in weights if w.dim() == 2))
    T, B, A = eps.shape
    d = dims_of(weights, h0, z0, eps)
    w = widths_of(d, rows, classes)
    blocks = blocks or sm_count(h0.device)
    plan, table = checked_plan(w, blocks, h0.device)
    f32 = dict(dtype=torch.float32, device=h0.device)
    b16 = dict(dtype=torch.bfloat16, device=h0.device)
    outs = (torch.empty(T, B, d.H, **f32), torch.empty(T, B, d.Z, **f32),
            torch.empty(T, B, A, **f32), torch.empty(T, B, A, **f32),
            torch.empty(T, B, A, **f32), torch.empty(B, d.H, **f32),
            torch.empty(B, d.Z, **f32))
    # The launch's record (zeroed by the C entry on the stream), x, the four
    # Dense outputs that a LayerNorm reads, the GRU's two f32 sums.
    scratch = (torch.empty(1 + blocks, dtype=torch.int32, device=h0.device),
               torch.empty(B, _r16(d.H) + _r16(d.Z), **b16),
               *(torch.empty(B, _r16(n), **b16) for n in (d.AH1, d.AH2, d.DH1, d.DH2)),
               torch.empty(B, 3 * d.H, **f32), torch.empty(B, 3 * d.H, **f32), table)
    ptrs = (ctypes.c_void_p * (N_WEIGHTS + 11 + N_SCRATCH))(
        *[t.data_ptr() for t in (*weights, h0, z0, eps, gum, *outs, *scratch)])
    dims = (ctypes.c_int * 18)(B, T, *w, *plan.table[:1], *plan.table[1:3], *plan.table[4:8])
    fn = cuda_build.kernel_fn("dt_imagine_rollout", _ARGTYPES)
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        status = fn(ptrs, dims, float(unimix), float(min_std), stream)
    cuda_build.check(status, "dt_imagine_rollout")
    imagine_rollout.launches += 1
    h_seq, z_seq, a_seq, mu_seq, sig_seq, h_fin, z_fin = outs
    return (h_fin, z_fin, h_seq, z_seq, a_seq, mu_seq, sig_seq), scratch[0]


imagine_rollout.launches = 0


def launch_record(record: torch.Tensor) -> Dict[str, int]:
    """What one launch did, from its record (``_launch``): the blocks that
    ran, the distinct SMs they ran on, and the grid barriers each block
    crossed (the barrier's final count over the blocks; ``BARRIERS_PER_STEP``
    times T for the kernel as designed)."""
    r = record.cpu().tolist()
    sms = [v - 1 for v in r[1:] if v]
    return {"blocks": len(sms), "sms": len(set(sms)),
            "barriers": r[0] // max(len(sms), 1), "count": r[0]}


# --------------------------------------------------------------------------- #
# Holding one step of the kernel against the plain version
# --------------------------------------------------------------------------- #


def compare_step(out: Step, ref: Step, rows: int, classes: int) -> Dict[str, float]:
    """Hold one step's outputs ``out`` against the plain version's ``ref``
    (the same inputs).  Returns the numbers of the comparison; ``failures``
    lists what broke (empty when it holds):

    - h', mu, sigma and the action within ``tolerance(ref)``;
    - the same category in every latent row, except rows whose plain top-two
      scores lie within NEAR_TIE (counted as ``near_ties``, of which
      ``flips`` sampled another category);
    - in the rows of the same category, the hot straight-through value within
      STE_ATOL of the plain one, and not an exact one-hot (see
      MIN_RESIDUAL_SHARE)."""
    stats: Dict[str, float] = {}
    failures = []
    for name in ("h_next", "mu", "sigma", "action"):
        o, r = getattr(out, name).float(), getattr(ref, name).float()
        diff = (o - r).abs()
        stats[f"max_abs_err_{name}"] = float(diff.max())
        if not bool(torch.isfinite(o).all()) or bool((diff > tolerance(r)).any()):
            failures.append(f"{name}: max |diff| {float(diff.max()):.3e} over the tolerance")
    zo = out.z_next.float().reshape(-1, rows, classes)
    zr = ref.z_next.float().reshape(-1, rows, classes)
    cat_o, cat_r = zo.argmax(-1), zr.argmax(-1)
    top2 = ref.scores.float().reshape(-1, rows, classes).topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    differ = cat_o != cat_r
    stats["rows"] = float(differ.numel())
    stats["near_ties"] = float(near.sum())
    stats["flips"] = float((differ & near).sum())
    stats["flips_not_near_tie"] = float((differ & ~near).sum())
    if stats["flips_not_near_tie"]:
        failures.append(f"{int(stats['flips_not_near_tie'])} latent rows sampled another "
                        "category outside a near tie")
    same = ~differ
    hot_o = zo.gather(-1, cat_o[..., None])[..., 0][same]
    hot_r = zr.gather(-1, cat_r[..., None])[..., 0][same]
    cold_o = zo.masked_fill(F.one_hot(cat_o, classes).bool(), 0.0)
    stats["max_abs_err_z_hot"] = float((hot_o - hot_r).abs().max()) if hot_o.numel() else 0.0
    stats["residual_share"] = float((hot_o != 1.0).float().mean()) if hot_o.numel() else 0.0
    if stats["max_abs_err_z_hot"] > STE_ATOL or bool(cold_o.abs().max() > STE_ATOL):
        failures.append(f"straight-through values off by {stats['max_abs_err_z_hot']:.3e}")
    if hot_o.numel() >= 64 and stats["residual_share"] < MIN_RESIDUAL_SHARE:
        failures.append(f"only {stats['residual_share']:.3f} of the hot entries carry the "
                        "(onehot + p) - p residual: an exact one-hot")
    stats["failures"] = failures
    return stats


def hold_steps(h_seq, z_seq, eps, gum, weights, unimix: float, min_std: float):
    """Every step of a rollout as one T = 1 launch over its T * B rows: the
    pre-step states h_seq (T, B, H) and z_seq (T, B, Z) with that step's eps
    and gum, held to ``imagine_step`` on the same rows by ``compare_step``.
    Returns (the comparison's numbers with the plain step's mean top
    probability, the launch's outputs as a ``Step``)."""
    T, B = eps.shape[:2]
    rows, classes = gum.shape[2:]
    N = T * B
    h, z = h_seq.reshape(N, -1).contiguous(), z_seq.reshape(N, -1).contiguous()
    e, g = eps.reshape(N, -1), gum.reshape(N, rows, classes)
    one = imagine_rollout(h, z, e[None].contiguous(), g[None].contiguous(), weights, unimix,
                          min_std)
    got = Step(one[0], one[1], one[4][0], one[5][0], one[6][0], None)
    ref = imagine_step(weights, h, z, e, g, unimix, min_std)
    stats = compare_step(got, ref, rows, classes)
    # How peaked the prior is: near flat, a sampler's faults hide in near ties.
    stats["mean_top_prob"] = float((ref.scores - g).exp().max(-1).values.mean())
    return stats, got


def hold_rollout(out, eps, gum, weights, unimix: float, min_std: float) -> Dict[str, float]:
    """Hold one whole-rollout launch ``out`` (``imagine_rollout``'s outputs
    from eps, gum and ``weights``) step by step.  The kernel is launched again
    at T = 1 from the rollout's own pre-step states (``hold_steps``); that
    launch runs the same code on the same numbers in the same order, so its
    h', z', action, mu and sigma must equal the rollout's next states and
    step outputs bit for bit (a fault in the carry of h and z across the time
    loop breaks this: ``carry_mismatches`` counts the (step, row) pairs that
    differ), and its step must hold to the plain step (``compare_step``)."""
    stats, got = hold_steps(out[2], out[3], eps, gum, weights, unimix, min_std)
    T, B = eps.shape[:2]
    want = {"h_next": torch.cat([out[2][1:], out[0][None]]),
            "z_next": torch.cat([out[3][1:], out[1][None]]),
            "action": out[4], "mu": out[5], "sigma": out[6]}
    differ = torch.zeros(T, B, dtype=torch.bool, device=eps.device)
    for name, w in want.items():
        differ |= (getattr(got, name).reshape(T, B, -1) != w).any(-1)
    stats["carry_mismatches"] = float(differ.sum())
    if stats["carry_mismatches"]:
        first = int(differ.any(-1).nonzero()[0, 0])
        stats["failures"].append(
            f"{int(stats['carry_mismatches'])} (step, row) pairs of the rollout differ from "
            f"the same step relaunched from the rollout's own states, the first at step "
            f"{first}")
    return stats


def rollout_agreement(out, ref, rows: int, classes: int) -> Dict[str, float]:
    """For two whole rollouts from the same inputs: the first step whose
    sampled categories differ (-1 if none) and the share of equal categories
    over all steps (z_seq[1:] and z_fin)."""
    def cats(o):
        z = torch.cat([o[3][1:], o[1][None]], dim=0).float()
        return z.reshape(z.shape[0], -1, rows, classes).argmax(-1)

    equal = cats(out) == cats(ref)
    per_step = equal.reshape(equal.shape[0], -1).all(-1)
    bad = (~per_step).nonzero()
    return {"first_step_differs": int(bad[0, 0]) + 1 if bad.numel() else -1,
            "equal_share": float(equal.float().mean())}


def bound_numbers(B: int, T: int, weights: Sequence[torch.Tensor], d: Dims):
    """(bytes, operations) that one rollout must move and do: every weight
    read once (the bf16 rows unpadded), h0, z0, eps and gum read and the
    outputs written, all f32; two operations per weight per row per step
    (the sampler's B T Z exp/log are a thousandth of that and not counted)."""
    n_w = (d.AH1 * (d.H + d.Z) + d.AH2 * d.AH1 + 2 * d.A * d.AH2 + 3 * d.H * (d.Z + d.A)
           + 3 * d.H * d.H + d.DH1 * d.H + d.DH2 * d.DH1 + d.Z * d.DH2)
    vec = sum(w.numel() for w in weights if w.dim() == 1)
    inputs = B * (d.H + d.Z) + T * B * (d.A + d.Z)
    outputs = T * B * (d.H + d.Z + 3 * d.A) + B * (d.H + d.Z)
    return 2 * n_w + 4 * (vec + inputs + outputs), 2 * B * T * n_w
