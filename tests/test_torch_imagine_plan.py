"""The imagination kernel's plan (``ops.imagine_cuda.imagine_plan``) and its
stage split, on the CPU.

The plan must give every output column of every layer to exactly one block,
fit each block's shared memory, and leave each output's summation order to
the widths alone.  The stage split (a step's six stages, with the GRU's input
sum taken as a z partial in the first and the action's rows added in the
third before one rounding) is emulated in plain PyTorch and held to
``imagine_step``: within ``compare_step``'s tolerance in bf16, to 1e-5 in
float32.  The card's own plan is held to this one in
``tests/test_torch_kernels.py``.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.actor_critic import Actor
from dreamer_tpu_torch.nets.wm_nets import WMNets
from dreamer_tpu_torch.ops import imagine_cuda as ic

WIDTHS = {
    "small": ic.Widths(H=64, Z=128, rows=8, classes=16, A=3, AH1=24, AH2=24, DH1=24, DH2=24),
    "flagship": ic.Widths(H=600, Z=1024, rows=32, classes=32, A=3, AH1=200, AH2=200,
                          DH1=200, DH2=200),
    "drone": ic.Widths(H=1024, Z=1024, rows=32, classes=32, A=4, AH1=400, AH2=400, DH1=400,
                       DH2=400),
}
BLOCKS = (1, 50, 114, 132)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _tiles(plan):
    """(block, stage, group, kind, index) of every tile of the plan."""
    for b, stages in enumerate(plan.stages):
        for s, groups in enumerate(stages):
            for g in groups:
                for kind, idx, _ in g.tiles:
                    yield b, s, g, kind, idx


@pytest.mark.parametrize("shape", sorted(WIDTHS))
@pytest.mark.parametrize("blocks", BLOCKS)
def test_plan_covers_every_column_once_and_fits(shape, blocks):
    """Every column of every Dense layer, every GRU gate column and every
    latent row is computed by exactly one block, in the stage that reads its
    inputs (the mu and sigma heads by every block); each block's shared
    memory fits an H100's."""
    w = WIDTHS[shape]
    plan = ic.imagine_plan(w, blocks)
    assert plan.blocks == blocks and len(plan.stages) == blocks
    assert plan.smem <= ic.SMEM_LIMIT == 232448
    stage_of = {ic.A0: 0, ic.WH: 0, ic.WI: 0, ic.A1: 1, ic.HD: 2, ic.D0: 3, ic.D1: 4, ic.D2: 5}
    widths = {ic.A0: w.AH1, ic.A1: w.AH2, ic.D0: w.DH1, ic.D1: w.DH2}
    seen = {k: [] for k in widths}
    gates = {ic.WH: [], ic.WI: []}
    latent = []
    heads = {b: [] for b in range(blocks)}
    for b, s, g, kind, idx in _tiles(plan):
        assert stage_of[kind] == s and len(g.tiles) <= ic.MAX_NT
        k0, k1 = ic.k_range(w, kind)
        assert g.k0 <= k0 < k1 <= g.k1 and k0 % 16 == 0 and k1 % 16 == 0
        if kind in widths:
            seen[kind] += [c for c in range(8 * idx, 8 * idx + 8) if c < widths[kind]]
        elif kind == ic.HD:
            heads[b] += [c for c in range(8 * idx, 8 * idx + 8) if c < 2 * w.A]
        elif kind in gates:
            u0, u1 = plan.gru[b]
            u = u1 - u0
            gates[kind] += [(c // u) * w.H + u0 + c % u for c in range(8 * idx, 8 * idx + 8)
                            if c < 3 * u]
    for b, stages in enumerate(plan.stages):
        for g in stages[5]:
            assert g.latent_row >= 0
            assert [t[1] for t in g.tiles] == list(ic.d2_tiles(w, g.latent_row))
            latent.append(g.latent_row)
    for kind, width in widths.items():
        assert sorted(seen[kind]) == list(range(width)), ic.KINDS[kind]
    for kind, cols in gates.items():
        assert sorted(cols) == list(range(3 * w.H)), ic.KINDS[kind]
    assert sorted(latent) == list(range(w.rows))
    # The heads run in every block, each with all 2A columns.
    assert all(sorted(c) == list(range(2 * w.A)) for c in heads.values())
    assert [u for u0, u1 in plan.gru for u in range(u0, u1)] == list(range(w.H))
    # Each block's weights and the fixed regions fit: all at once when
    # stationary, else the largest pass's.
    fixed = plan.smem - (plan.weight_bytes + 127) // 128 * 128
    for stages in plan.stages:
        per_pass = [sum(ic.tile_bytes(w, t[0]) for t in g.tiles) for st in stages for g in st]
        held = sum(per_pass) if plan.stationary else max(per_pass, default=0)
        assert held <= plan.weight_bytes and held + fixed <= ic.SMEM_LIMIT
        offsets = sorted(t[2] for st in stages for g in st for t in g.tiles)
        assert len(set(offsets)) == len(offsets) or not plan.stationary


def test_plan_holds_the_weights_at_the_paths_widths():
    """On an H100 SXM's 132 SMs the flagship's and the drone's slices stay
    in shared memory for the whole rollout, and every block has GRU units;
    on an H100 PCIe's 114 the drone's do not fit, and its passes stream
    their weights."""
    for shape in ("flagship", "drone"):
        plan = ic.imagine_plan(WIDTHS[shape], 132)
        assert plan.stationary and all(u1 > u0 for u0, u1 in plan.gru), shape
    assert ic.imagine_plan(WIDTHS["flagship"], 114).stationary
    assert not ic.imagine_plan(WIDTHS["drone"], 114).stationary
    assert not ic.imagine_plan(WIDTHS["flagship"], 1).stationary


def test_a_c_plan_that_differs_is_refused(monkeypatch):
    """The wrapper holds the C source's plan table to ``imagine_plan``'s
    before a shape's first launch and refuses the shape if one entry
    differs."""
    w = WIDTHS["small"]
    table = ic.imagine_plan(w, 50).table
    monkeypatch.setattr(ic, "_plans", {})
    monkeypatch.setattr(ic, "c_plan_table", lambda *_: table[:-1] + (table[-1] + 1,))
    with pytest.raises(RuntimeError, match="differs from imagine_plan"):
        ic.checked_plan(w, 50, torch.device("cpu"))
    monkeypatch.setattr(ic, "c_plan_table", lambda *_: table)
    plan, on_device = ic.checked_plan(w, 50, torch.device("cpu"))
    assert plan.table == table and on_device.tolist() == list(table)


def _visited(w, group, kind):
    """The k16 steps of one tile of ``group`` in the order the kernel's pass
    adds them into each slice's sum: chunks of KC k from the one holding the
    group's first k, step s and s + SLICES of each chunk by slice s."""
    k0, k1 = ic.k_range(w, kind)
    order = [[] for _ in range(ic.SLICES)]
    for c in range(group.k0 // ic.KC, -(-group.k1 // ic.KC)):
        for j in range(ic.KC // 16 // ic.SLICES):
            for s in range(ic.SLICES):
                k = c * ic.KC + 16 * (s + ic.SLICES * j)
                if group.k0 <= k < group.k1 and k0 <= k < k1:
                    order[s].append(k)
    return tuple(tuple(o) for o in order)


@pytest.mark.parametrize("shape", sorted(WIDTHS))
def test_k_order_depends_on_the_widths_alone(shape):
    """Whatever pass a tile lands in, over any block count, each slice adds
    the same k16 steps in the same order (``k_schedule``); rows never enter
    the plan, so no row count can change it either."""
    w = WIDTHS[shape]
    for blocks in BLOCKS:
        plan = ic.imagine_plan(w, blocks)
        for _, _, g, kind, _ in _tiles(plan):
            assert _visited(w, g, kind) == ic.k_schedule(w, kind), (blocks, ic.KINDS[kind])
    steps = [k for kind in range(len(ic.KINDS)) for s in ic.k_schedule(w, kind) for k in s]
    assert len(steps) == sum(len(range(*ic.k_range(w, kind), 16))
                             for kind in range(len(ic.KINDS)))


# --------------------------------------------------------------------------- #
# The stage split, emulated
# --------------------------------------------------------------------------- #


def _sliced(x, w, k_abs0=0):
    """x (N, K) . w (out, >= K)^T summed as the kernel sums it: x padded with
    zeros to whole k16 steps, each slice's steps (absolute index s mod 4,
    the first at k_abs0) summed in f32, the slice sums added in order."""
    K = x.shape[-1]
    kp = -(-K // 16) * 16
    xp = F.pad(x.float(), (0, kp - K))
    wp = F.pad(w[:, :K].float(), (0, kp - K))
    total = None
    for s in range(ic.SLICES):
        cols = [k + i for k in range(0, kp, 16) if ((k_abs0 + k) // 16) % ic.SLICES == s
                for i in range(16)]
        part = xp[:, cols] @ wp[:, cols].t() if cols else xp[:, :0] @ wp[:, :0].t()
        total = part if total is None else total + part
    return total


def _dense(x, w, b, dt, k_abs0=0):
    return (_sliced(x, w, k_abs0).to(dt) + b.to(dt)).float()


def _pad16(v):
    return F.pad(v, (0, -(-v.shape[-1] // 16) * 16 - v.shape[-1]))


def split_step(weights, h, z, eps, gum, unimix, min_std):
    """One step as the kernel's six stages compute it, in ``weights[0]``'s
    dtype: S1 actor Dense_0 over x = [h | z] with each part padded to whole
    k16 steps, gh, and gi's z partial (the first Z // 16 * 16 rows of W_i,
    unrounded); S2 actor Dense_1; S3 the heads, the action, and gi = the z
    partial + the rest of z and the action row by row, rounded once with its
    bias, then the gates; S4-S6 the prior and the sampler."""
    (a0w, a0b, al0s, al0b, a1w, a1b, al1s, al1b, muw, mub, sgw, sgb,
     wi, wh, bi, bh, d0w, d0b, dl0s, dl0b, d1w, d1b, dl1s, dl1b, d2w, d2b) = weights
    dt = a0w.dtype
    H, Z = h.shape[-1], z.shape[-1]
    h16 = -(-H // 16) * 16
    ln = lambda y, s, b: ic._ln_silu(y, s, b, dt)  # noqa: E731
    # S1: x as the kernel stores it, and actor Dense_0's weights laid out on it.
    x = torch.cat([_pad16(h.to(dt)), _pad16(z.to(dt))], -1)
    a0x = torch.cat([_pad16(a0w[:, :H]), _pad16(a0w[:, H:H + Z])], -1)
    ya0 = _dense(x, a0x, a0b, dt)
    gh = _dense(x[:, :h16], _pad16(wh[:, :H]), bh, dt)
    zf = Z // 16 * 16
    giz = _sliced(x[:, h16:h16 + zf], wi[:, :zf], h16) if zf else 0.0
    # S2, S3
    ya1 = _dense(ln(ya0, al0s, al0b), a1w, a1b, dt)
    xh = ln(ya1, al1s, al1b)
    mu = _dense(xh, muw, mub, dt)
    sigma = F.softplus(torch.clamp(_dense(xh, sgw, sgb, dt), -5.0, 2.0)) + min_std
    action = torch.tanh(mu + sigma * eps)
    tail = torch.cat([z[:, zf:], action], -1).to(dt).float()
    gi = giz + tail @ wi[:, zf:Z + action.shape[-1]].float().t()
    gi = (gi.to(dt) + bi.to(dt)).float()
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    zg = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    h_next = (1.0 - zg) * n + zg * h
    # S4-S6
    yd0 = _dense(h_next.to(dt), d0w, d0b, dt)
    yd1 = _dense(ln(yd0, dl0s, dl0b), d1w, d1b, dt)
    logits = _dense(ln(yd1, dl1s, dl1b), d2w, d2b, dt).reshape(gum.shape)
    probs = (1.0 - unimix) * torch.softmax(logits, -1) + unimix / gum.shape[-1]
    scores = torch.log(probs) + gum
    onehot = F.one_hot(scores.argmax(-1), gum.shape[-1]).float()
    z_next = ((onehot + probs) - probs).reshape(z.shape)
    return ic.Step(h_next, z_next, action, mu, sigma, scores)


def _operands(shape, n, dtype, seed=0):
    """The small or flagship widths (the drone's take longer than the
    budget of this file), every parameter the init leaves zero drawn."""
    g = torch.Generator().manual_seed(seed)
    cfg = DreamerConfig.from_yaml(os.path.join(CONFIGS, "car_racer.yaml"))
    c, hidden = cfg.wm, 200
    if shape == "small":
        c.hidden_dim, c.latent_rows, c.latent_classes = 64, 8, 16
        c.dyn_hidden_1 = c.dyn_hidden_2 = hidden = 24
    nets = WMNets(c, 3, dtype, g)
    actor = Actor(c.hidden_dim + c.latent_dim, 3, hidden, hidden, cfg.agent.min_std, dtype, g)
    with torch.no_grad():
        for m in (nets, actor):
            for p in m.parameters():
                if not p.any():
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
    weights = [*actor.imagine_weights(), *nets.imagine_weights()]
    h = torch.randn(n, c.hidden_dim, generator=g).tanh()
    z = F.one_hot(torch.randint(0, c.latent_classes, (n, c.latent_rows), generator=g),
                  c.latent_classes).float().reshape(n, -1)
    eps = torch.randn(n, 3, generator=g)
    u = torch.rand(n, c.latent_rows, c.latent_classes, generator=g).clamp_(min=1e-30)
    return (weights, h, z, eps, -torch.log(-torch.log(u)), c.latent_rows, c.latent_classes,
            c.unimix, cfg.agent.min_std)


@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_stage_split_holds_to_imagine_step_in_bf16(shape):
    weights, h, z, eps, gum, rows, classes, unimix, min_std = _operands(shape, 64,
                                                                        torch.bfloat16)
    got = split_step(weights, h, z, eps, gum, unimix, min_std)
    ref = ic.imagine_step(weights, h, z, eps, gum, unimix, min_std)
    stats = ic.compare_step(got, ref, rows, classes)
    assert stats["failures"] == [], stats


@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_stage_split_is_imagine_step_in_float32(shape):
    weights, h, z, eps, gum, rows, classes, unimix, min_std = _operands(shape, 16,
                                                                        torch.float32, seed=1)
    got = split_step(weights, h, z, eps, gum, unimix, min_std)
    ref = ic.imagine_step(weights, h, z, eps, gum, unimix, min_std)
    for name in ("h_next", "z_next", "action", "mu", "sigma", "scores"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), atol=1e-5, rtol=1e-5,
                                   msg=name)


def test_stage_split_without_the_action_rows_fails():
    """The emulation's check sees a gi that left out the action's rows."""
    weights, h, z, eps, gum, rows, classes, unimix, min_std = _operands("small", 64,
                                                                        torch.bfloat16)
    faulty = list(weights)
    faulty[12] = weights[12].clone()
    faulty[12][:, 128:131] = 0  # W_i's action rows
    got = split_step(faulty, h, z, eps, gum, unimix, min_std)
    ref = ic.imagine_step(weights, h, z, eps, gum, unimix, min_std)
    assert ic.compare_step(got, ref, rows, classes)["failures"]
