"""The kernel wrappers of dreamer_tpu_torch.ops: what they accept, that a CPU
tensor takes the plain version (and is not counted as a launch), that any
other device launches the kernel or raises, and the kernels' weight layouts.

The tests marked ``cuda`` build and run the CUDA kernels; they skip without a
card.  On the card: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
Tolerances there are each wrapper's ``tolerance`` (``ops.gru_cuda``: 2e-2
abs/rel; ``ops.gru_scan_cuda``: 1e-3 abs/rel, and ``hold_scan``: a T-step
launch reproduced bit for bit by its steps relaunched at T = 1;
``ops.conv_cuda``: 2**-6 of the largest feature) or check
(``ops.imagine_cuda.compare_step``: 2e-2 abs/rel on h', mu, sigma and the
action, the same categories outside near ties; ``hold_rollout``: a whole
rollout reproduced bit for bit by its steps relaunched), the same that
chip_smoke.py holds the kernels to; each module says why."""

import os
import re

import pytest
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.actor_critic import Actor
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.nets.layout import KernelLayout
from dreamer_tpu_torch.nets.wm_nets import WMNets
from dreamer_tpu_torch.ops import conv_cuda, cuda_build, gru_cuda, gru_scan_cuda, imagine_cuda
from dreamer_tpu_torch.ops.conv_cuda import (encoder_forward, encoder_forward_plain,
                                             encoder_kernel_layout, norm_table)
from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_cell_plain, gru_kernel_layout
from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan, gru_scan_plain, hold_scan
from dreamer_tpu_torch.ops.imagine_cuda import (dense_rows, imagine_rollout,
                                                imagine_rollout_plain, imagine_step,
                                                layer_operands)

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "car_racer.yaml")
DRONE = os.path.join(os.path.dirname(FLAGSHIP), "drone.yaml")


def gru_operands(n=5, i=13, h=11, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, hh = torch.randn(n, i, generator=g), torch.randn(n, h, generator=g)
    cell = GRUCell(i, h, dtype, g)
    return x.to(dtype), hh.to(dtype), cell.kernel_weights()


def gru_scan_operands(t=4, n=5, i=13, h=11, dtype=torch.float32, seed=0):
    """(xs, h0, the kernel layout) with the GRU cell's uniform init."""
    g = torch.Generator().manual_seed(seed)
    xs, h0 = torch.randn(t, n, i, generator=g), torch.randn(n, h, generator=g).clamp(-1, 1)
    cell = GRUCell(i, h, dtype, g)
    return xs.to(dtype), h0, cell.kernel_weights()


def encoder_operands(n=3, size=32, filters=(4, 8), dtype=torch.float32, seed=0,
                     rounding="serve"):
    """(obs, HWIO weights, f32 biases, the normalisation table)."""
    g = torch.Generator().manual_seed(seed)
    cfg = DreamerConfig().wm
    cfg.obs_size, cfg.encoder_filters_1, cfg.encoder_filters_2 = (size, size), *filters
    nets = WMNets(cfg, 3, dtype, g)
    with torch.no_grad():  # the init leaves them zero; a dropped bias must show
        for c in nets.enc_convs:
            c.bias.copy_(0.1 * torch.randn(c.bias.shape, generator=g))
    obs = torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, generator=g)
    return obs, *nets.encoder_weights(), norm_table(rounding, dtype)


def imagine_operands(shape, n=4, steps=6, dtype=torch.bfloat16, seed=0):
    """(h0, z0, eps, gum, weights, rows, classes, unimix, min_std) with every
    parameter that the init leaves zero drawn ~ N(0, 0.1): at the SMALL
    widths of tests/test_imagine_pallas.py (8 x 16 latents), the flagship's
    (configs/car_racer.yaml) or the drone's (configs/drone.yaml: GRU 1024,
    hiddens 400, 4 actions)."""
    g = torch.Generator().manual_seed(seed)
    cfg = DreamerConfig.from_yaml(DRONE if shape == "drone" else FLAGSHIP)
    c, hidden, actions = cfg.wm, cfg.agent.actor_hidden_1, cfg.env.action_dim
    if shape == "small":
        c.hidden_dim, c.latent_rows, c.latent_classes = 64, 8, 16
        c.dyn_hidden_1 = c.dyn_hidden_2 = hidden = 24
    nets = WMNets(c, actions, dtype, g)
    actor = Actor(c.hidden_dim + c.latent_dim, actions, hidden, hidden, cfg.agent.min_std, dtype,
                  g)
    with torch.no_grad():
        for m in (nets, actor):
            for p in m.parameters():
                if not p.any():
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
    weights = [*actor.imagine_weights(), *nets.imagine_weights()]
    h0 = torch.randn(n, c.hidden_dim, generator=g).tanh()
    z0 = torch.nn.functional.one_hot(torch.randint(0, c.latent_classes, (n, c.latent_rows),
                                                   generator=g), c.latent_classes)
    eps = torch.randn(steps, n, actions, generator=g)
    u = torch.rand(steps, n, c.latent_rows, c.latent_classes, generator=g).clamp_(min=1e-30)
    return (h0, z0.float().reshape(n, -1), eps, -torch.log(-torch.log(u)), weights,
            c.latent_rows, c.latent_classes, c.unimix, cfg.agent.min_std)


@pytest.fixture
def no_launch_counted():
    kernels = (gru_cell, gru_scan, encoder_forward, imagine_rollout)
    before = [k.launches for k in kernels]
    yield
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_cell_on_cpu_is_the_plain_version(dtype, no_launch_counted):
    x, h, ops = gru_operands(dtype=dtype)
    out = gru_cell(x, h, *ops)
    assert out.dtype == dtype and out.shape == h.shape
    assert torch.equal(out, gru_cell_plain(x, h, *ops))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_on_cpu_is_the_plain_version(dtype, no_launch_counted):
    obs, ws, bs, table = encoder_operands(dtype=dtype)
    out = encoder_forward(obs, ws, bs, table)
    assert out.dtype == dtype and out.shape == (3, 2 * 2 * 32)
    assert torch.equal(out, encoder_forward_plain(obs, ws, bs, table))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_scan_on_cpu_is_the_plain_version(dtype, no_launch_counted):
    xs, h0, ops = gru_scan_operands(dtype=dtype)
    out = gru_scan(xs, h0, *ops)
    assert [tuple(o.shape) for o in out] == [(4, 5, 11)] * 5
    assert all(o.dtype == torch.float32 for o in out)
    assert all(torch.equal(a, b) for a, b in zip(out, gru_scan_plain(xs, h0, *ops)))
    # Its first step is the cell's gate math on the same operands.
    ref = gru_cell_plain(xs[0], h0.to(dtype), *ops)
    if dtype == torch.float32:
        assert torch.allclose(out[0][0], ref, atol=1e-6)


def test_gru_kernel_layout_pads_and_transposes():
    g = torch.Generator().manual_seed(0)
    wi, wh = torch.randn(13, 33, generator=g), torch.randn(11, 33, generator=g)
    bi, bh = torch.randn(33, generator=g), torch.randn(33, generator=g)
    wi_t, wh_t, bi2, bh2 = gru_kernel_layout(wi, wh, bi, bh, torch.bfloat16)
    assert wi_t.shape == (33, 16) and wh_t.shape == (33, 16)
    assert wi_t.dtype == torch.bfloat16 and bi2.dtype == torch.float32
    assert torch.equal(wi_t[:, :13], wi.t().to(torch.bfloat16))
    assert not wi_t[:, 13:].any() and not wh_t[:, 11:].any()
    assert torch.equal(bi2, bi.to(torch.bfloat16).float())  # rounded as the flax cell does


def test_imagine_on_cpu_is_the_plain_version(no_launch_counted):
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands("small")
    out = imagine_rollout(h0, z0, eps, gum, w, unimix, min_std)
    ref = imagine_rollout_plain(h0, z0, eps, gum, w, unimix, min_std)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert [tuple(o.shape) for o in out] == [(4, 64), (4, 128), (6, 4, 64), (6, 4, 128),
                                             (6, 4, 3), (6, 4, 3), (6, 4, 3)]


def _rollout_row_by_row(h0, z0, eps, gum, w, unimix, min_std):
    """``imagine_rollout_plain`` one row at a time, so that its numbers do not
    depend on how many rows share the call: the kernel keeps that property
    with one summation order per output fixed by the widths (each row in its
    own lane of the tensor-core tiles, the k slices added in a fixed order),
    whatever the rows, row groups and blocks of its launch."""
    outs = [imagine_rollout_plain(h0[i:i + 1], z0[i:i + 1], eps[:, i:i + 1], gum[:, i:i + 1],
                                  w, unimix, min_std) for i in range(h0.shape[0])]
    return tuple(torch.cat([o[k] for o in outs], dim=0 if k < 2 else 1) for k in range(7))


@pytest.mark.parametrize("fault", ["none", "h_seq", "z_fin", "mu_seq"])
def test_hold_rollout_fails_a_rollout_its_own_steps_do_not_reproduce(monkeypatch, fault):
    """``hold_rollout`` relaunches every step from the rollout's own states;
    one f32 step off in a carried state or an output (a faulty carry across
    the kernel's time loop) fails it."""
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands("small")
    monkeypatch.setattr(imagine_cuda, "imagine_rollout", _rollout_row_by_row)
    out = list(_rollout_row_by_row(h0, z0, eps, gum, w, unimix, min_std))
    if fault == "h_seq":  # the state carried into step 3 of row 1
        out[2] = out[2].clone()
        out[2][3, 1, 0] = torch.nextafter(out[2][3, 1, 0], torch.tensor(2.0))
    elif fault == "z_fin":  # the last step's straight-through residual dropped
        assert not torch.equal(out[1], out[1].round())
        out[1] = out[1].round()
    elif fault == "mu_seq":
        out[5] = out[5].clone()
        out[5][2, 0, 1] = torch.nextafter(out[5][2, 0, 1], torch.tensor(2.0))
    stats = imagine_cuda.hold_rollout(out, eps, gum, w, unimix, min_std)
    assert (stats["carry_mismatches"] == 0) == (fault == "none"), stats
    assert (stats["failures"] == []) == (fault == "none"), stats


def test_imagine_kernel_layout_pads_rows_and_rounds_dense_biases():
    w, b = torch.randn(5, 13), torch.randn(5)
    s, lb = torch.randn(5), torch.randn(5)
    rows = dense_rows(w, torch.bfloat16)
    assert rows.shape == (5, 16) and rows.dtype == torch.bfloat16 and not rows[:, 13:].any()
    assert torch.equal(rows[:, :13], w.to(torch.bfloat16))
    ops = layer_operands([w, b, s, lb], torch.bfloat16)
    assert torch.equal(ops[1], b.to(torch.bfloat16).float())  # added in bf16
    assert torch.equal(ops[2], s) and torch.equal(ops[3], lb)  # LayerNorm stays f32


def test_encoder_kernel_layout_is_hwio():
    w = torch.randn(8, 3, 4, 4)
    (w_hwio,), (b,) = encoder_kernel_layout([w], [torch.zeros(8)], torch.bfloat16)
    assert w_hwio.shape == (4, 4, 3, 8) and w_hwio.is_contiguous()
    assert torch.equal(w_hwio[1, 2, 0], w[:, 0, 1, 2].to(torch.bfloat16))


ENCODER_SHAPES = [(1, 64, 64, (32, 64, 128, 256)), (13, 64, 64, (32, 64, 128, 256)),
                  (64, 64, 64, (32, 64, 128, 256)), (1250, 64, 64, (32, 64, 128, 256)),
                  (1500, 64, 64, (32, 64, 128, 256)), (3, 64, 64, (48, 96, 192, 384)),
                  (3, 32, 32, (4, 8, 16, 32)), (2, 16, 16, (8, 8, 16, 32)),
                  (5, 48, 80, (12, 20, 40, 80)), (2, 128, 128, (32, 64, 128, 256))]


@pytest.mark.parametrize("n,h,w,chans", ENCODER_SHAPES)
def test_encoder_plan_fits_and_covers_every_output(n, h, w, chans):
    """Each layer's launch is one the kernel is built for, fits in shared
    memory, and its blocks cover every frame, pixel and channel; a weight
    K-chunk is whole k16 steps and divides K."""
    plans = conv_cuda.encoder_plan(n, h, w, chans)
    cin = 3
    for l, (p, co) in enumerate(zip(plans, chans)):
        hwo = (h >> l + 1) * (w >> l + 1)
        k = 16 * conv_cuda.stored_channels(cin)
        assert p.mt in conv_cuda.TILES and p.nt in conv_cuda.TILES
        assert p.bn == p.wn * p.nt * 8 and p.bn & (p.bn - 1) == 0
        assert p.bm == conv_cuda.WARPS // p.wn * p.mt * 16
        assert p.smem <= conv_cuda.SMEM_LIMIT
        assert p.kc % 16 == 0 and k % p.kc == 0
        nb = -(-(co if l == 3 else conv_cuda.stored_channels(co)) // p.bn)
        assert p.blocks % nb == 0
        row_blocks = p.blocks // nb
        if p.g > 1:
            assert p.g * hwo <= p.bm and row_blocks * p.g >= n > (row_blocks - 1) * p.g
        else:
            assert row_blocks == n * -(-hwo // p.bm)
        assert p == conv_cuda.layer_plan(n, h >> l, w >> l, cin, co, p.mt, p.nt, p.wn, l)
        cin = co


def test_encoder_plan_spreads_few_frames_and_tiles_many():
    """Serving's 1 and 64 frames put every layer on more blocks than frames,
    so that more SMs work than there are frames; the learner's 1500 take the
    largest warp tile in every layer, each weight chunk serving at least 64
    rows (4 frames in layer 3), and at least one block per SM in every layer."""
    chans = (32, 64, 128, 256)
    for n in (1, 64):
        assert all(p.blocks > n for p in conv_cuda.encoder_plan(n, 64, 64, chans))
    for p in conv_cuda.encoder_plan(1500, 64, 64, chans):
        assert (p.mt, p.nt) == (4, 4) and p.bm >= 64 and p.blocks >= 132


def test_stored_channels_pad_to_whole_k16_steps():
    assert [conv_cuda.stored_channels(c) for c in (1, 3, 4, 5, 8, 9, 17, 48, 96)] == \
        [4, 4, 4, 16, 16, 16, 32, 48, 96]


def test_gru_tolerance_is_below_the_size_of_its_output():
    x, h, ops = gru_operands(16, 67, 64)
    ref = gru_cell_plain(x, h, *ops)
    assert bool((gru_cuda.tolerance(ref) < 0.1 * ref.abs().max()).all())


@pytest.mark.parametrize("fault", ["no_bias", "no_tap"])
def test_encoder_tolerance_fails_a_faulty_kernel(fault):
    """At the flagship widths, with the biases drawn as the card's checks draw
    them, the encoder's tolerance is below the features' rms, and a version
    that drops the biases, or one tap (ky = kx = 3) of every layer, fails it."""
    obs, ws, bs, table = encoder_operands(2, 64, (32, 64), torch.bfloat16)
    ref = encoder_forward_plain(obs, ws, bs, table)
    tol = conv_cuda.tolerance(ref)
    assert float(tol) < 0.5 * float(ref.float().square().mean().sqrt())
    if fault == "no_bias":
        bs = [torch.zeros_like(b) for b in bs]
    else:
        ws = [w.clone() for w in ws]
        for w in ws:
            w[3, 3] = 0
    out = encoder_forward_plain(obs, ws, bs, table)
    assert bool(((out.float() - ref.float()).abs() > tol).any())


def test_kernel_layout_rebuilds_only_when_a_parameter_changes():
    p = torch.nn.Parameter(torch.ones(3))
    builds = []
    cache = KernelLayout(lambda q: builds.append(1) or q.clone() * 2)
    first = cache.get(p)
    assert cache.get(p) is first and len(builds) == 1
    with torch.no_grad():
        p.add_(1.0)  # in place: the version counter moves
    assert torch.equal(cache.get(p), torch.full((3,), 4.0)) and len(builds) == 2
    q = torch.nn.Parameter(torch.ones(3))  # a new tensor, e.g. after .to()
    cache.get(q)
    assert len(builds) == 3


@pytest.mark.parametrize("case", ["x_rank", "rows", "wi_shape", "bias_dtype", "mixed_dtype",
                                  "noncontig"])
def test_gru_cell_rejects_bad_operands(case):
    x, h, (wi_t, wh_t, bi, bh) = gru_operands()
    if case == "x_rank":
        x = x[None]
    elif case == "rows":
        h = h[:-1]
    elif case == "wi_shape":
        wi_t = wi_t[:, :-8]
    elif case == "bias_dtype":
        bi = bi.double()
    elif case == "mixed_dtype":
        h = h.to(torch.bfloat16)
    else:
        x = torch.cat([x, x], 1)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        gru_cell(x, h, wi_t, wh_t, bi, bh)


@pytest.mark.parametrize("case", ["dtype", "channels", "size", "layers", "weight", "bias",
                                  "table"])
def test_encoder_rejects_bad_operands(case):
    obs, ws, bs, table = encoder_operands()
    if case == "dtype":
        obs = obs.float()
    elif case == "channels":
        obs = obs[..., :2]
    elif case == "size":
        obs = obs[:, :24, :24]
    elif case == "layers":
        ws, bs = ws[:3], bs[:3]
    elif case == "weight":
        ws = [ws[0], ws[2], ws[1], ws[3]]
    elif case == "bias":
        bs = [b.double() for b in bs]
    else:
        table = table.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        encoder_forward(obs, ws, bs, table)


@pytest.mark.parametrize("case", ["x_rank", "rows", "wi_shape", "h0_dtype", "mixed_dtype",
                                  "noncontig", "no_steps"])
def test_gru_scan_rejects_bad_operands(case):
    xs, h0, (wi_t, wh_t, bi, bh) = gru_scan_operands()
    if case == "x_rank":
        xs = xs[0]
    elif case == "rows":
        h0 = h0[:-1]
    elif case == "wi_shape":
        wi_t = wi_t[:, :-8]
    elif case == "h0_dtype":
        h0 = h0.to(torch.bfloat16)
    elif case == "mixed_dtype":
        xs = xs.to(torch.bfloat16)
    elif case == "noncontig":
        xs = xs.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        xs = xs[:0]
    with pytest.raises((ValueError, TypeError)):
        gru_scan(xs, h0, wi_t, wh_t, bi, bh)


def test_off_the_cpu_the_wrappers_launch_or_raise(no_launch_counted):
    """A tensor on a device that is neither the CPU nor CUDA gets no plain
    fallback: the wrapper raises."""
    x, h, ops = gru_operands()
    meta = lambda ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(TypeError, match="kernel takes"):
        gru_cell(*meta([x, h, *ops]))
    obs, ws, bs, table = encoder_operands()
    with pytest.raises(TypeError, match="kernel takes"):
        encoder_forward(obs.to("meta"), meta(ws), meta(bs), table.to("meta"))
    xs, h0, ops = gru_scan_operands()
    with pytest.raises(TypeError, match="kernel takes"):
        gru_scan(*meta([xs, h0, *ops]))
    h0, z0, eps, gum, w, _, _, unimix, min_std = imagine_operands("small")
    with pytest.raises(TypeError, match="kernel takes"):
        imagine_rollout(*meta([h0, z0, eps, gum]), meta(w), unimix, min_std)


def test_each_kernel_source_carries_its_note():
    srcs = {p.name: p.read_text() for p in cuda_build.sources()}
    assert {"gru_cell.cu", "gru_scan.cu", "encoder.cu", "imagine.cu", "common.cu"} <= set(srcs)
    for name, ref in (("gru_cell.cu", "dreamer_tpu/ops/gru_pallas.py"),
                      ("gru_scan.cu", "dreamer_tpu/ops/gru_pallas.py"),
                      ("encoder.cu", "dreamer_tpu/ops/conv_pallas.py"),
                      ("imagine.cu", "dreamer_tpu/ops/imagine_pallas.py")):
        assert re.search(rf"Replaces: {re.escape(ref)}", srcs[name])
        assert "What bounds it" in srcs[name] and "Design:" in srcs[name]
        assert 'extern "C" int dt_' in srcs[name]


def test_each_mutant_changes_one_line_of_its_kernel_source():
    """Each faulty copy that chip_mutants.py builds replaces a line found
    exactly once in its kernel's source, so the copy is the right kernel but
    for that line."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_mutants", os.path.join(os.path.dirname(FLAGSHIP), "..", "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    srcs = {p.name: p.read_text() for p in cuda_build.files()}
    assert {m[0] for m in mutants.MUTANTS.values()} == {"gru_scan.cu", "gru_core.cuh",
                                                        "encoder.cu", "imagine.cu"}
    assert sum(m[0] == "imagine.cu" for m in mutants.MUTANTS.values()) >= 3
    for source, good, bad, checks in mutants.MUTANTS.values():
        assert srcs[source].count(good) == 1 and bad != good
        assert checks and set(checks) <= set(mutants.CHECKS)


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    key = cuda_build._digest()
    assert key == cuda_build._digest() and re.fullmatch(r"[0-9a-f]{16}", key)
    for src in cuda_build.files():  # the sources and the headers they include
        (tmp_path / src.name).write_text(src.read_text())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert cuda_build._digest() == key
    (tmp_path / "gru_cell.cu").write_text("// changed\n")
    assert cuda_build._digest() != key


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tolerance):
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= tolerance(ref)).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,i,h", [(1, 1027, 600), (50, 1027, 600), (64, 1027, 600),
                                   (1500, 1027, 600), (3, 13, 11), (9, 67, 64), (70, 37, 29)])
def test_gru_kernel_matches_plain_on_card(cuda, n, i, h):
    x, hh, ops = gru_operands(n, i, h, torch.bfloat16)
    x, hh, ops = x.to(cuda), hh.to(cuda), [o.to(cuda) for o in ops]
    before = gru_cell.launches
    out = gru_cell(x, hh, *ops)
    torch.cuda.synchronize()
    assert gru_cell.launches == before + 1
    _close(out, gru_cell_plain(x, hh, *ops), gru_cuda.tolerance)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", ["serve", "train"])
@pytest.mark.parametrize("n,size,filters", [(1, 64, (32, 64)), (50, 64, (32, 64)),
                                            (3, 64, (48, 96)),  # car_racer_64env.yaml
                                            (3, 32, (4, 8)), (2, 16, (8, 8)),
                                            # the learner's frames, serving's 64 envs and a
                                            # count no frames-per-block grouping divides
                                            (1250, 64, (32, 64)), (1500, 64, (32, 64)),
                                            (64, 64, (32, 64)), (13, 64, (32, 64))])
def test_encoder_kernel_matches_plain_on_card(cuda, n, size, filters, rounding):
    obs, ws, bs, table = encoder_operands(n, size, filters, torch.bfloat16, rounding=rounding)
    obs, table = obs.to(cuda), table.to(cuda)
    ws, bs = [w.to(cuda) for w in ws], [b.to(cuda) for b in bs]
    before = encoder_forward.launches
    out = encoder_forward(obs, ws, bs, table)
    torch.cuda.synchronize()
    assert encoder_forward.launches == before + 1
    _close(out, encoder_forward_plain(obs, ws, bs, table), conv_cuda.tolerance)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,i,h", [(30, 50, 1027, 600), (1, 1500, 1027, 600),
                                     (5, 10, 37, 29), (3, 9, 67, 64), (1, 70, 37, 29),
                                     (2, 20, 13, 40)])
def test_gru_scan_kernel_matches_plain_on_card(cuda, t, n, i, h):
    """All five outputs within ``gru_scan_cuda.tolerance`` of the plain
    version; a T-step launch reproduced bit for bit by its steps relaunched
    at T = 1 from its own states (``hold_scan``)."""
    xs, h0, ops = gru_scan_operands(t, n, i, h, torch.bfloat16)
    xs, h0, ops = xs.to(cuda), h0.to(cuda), [o.to(cuda) for o in ops]
    before = gru_scan.launches
    out = gru_scan(xs, h0, *ops)
    torch.cuda.synchronize()
    assert gru_scan.launches == before + 1
    stats = gru_scan_cuda.compare(out, gru_scan_plain(xs, h0, *ops))
    assert stats["failures"] == [], stats
    stats = hold_scan(out, xs, h0, ops)
    assert stats["failures"] == [] and stats["carry_mismatches"] == 0, stats


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 300, 1500])
def test_gru_scan_step_reproduces_the_cell_on_card(cuda, n):
    """At T = 1 on a bf16-valued h the scan kernel sums as the cell kernel
    does (one K schedule; its h_lo half is zero): its h' rounded to bf16 is
    the cell's output, at the learner's 50 rows and at the 1500 of the
    world-model update's backward."""
    xs, h0, ops = gru_scan_operands(1, n, 1027, 600, torch.bfloat16)
    xs, ops = xs.to(cuda), [o.to(cuda) for o in ops]
    h16 = h0.to(cuda, torch.bfloat16)
    out = gru_scan(xs, h16.float(), *ops)
    assert torch.equal(out[0][0].to(torch.bfloat16), gru_cell(xs[0], h16, *ops))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cell", "scan"])
def test_gru_rows_do_not_depend_on_their_launch_on_card(cuda, kernel):
    """The 1500 rows of one launch (the many-rows plan) equal 30 launches of
    50 rows each (the few-rows plan) bit for bit: an output's sums do not
    depend on the tile plan, as hold_observe and hold_scan need."""
    xs, h0, ops = gru_scan_operands(1, 1500, 1027, 600, torch.bfloat16, seed=3)
    x, ops = xs[0].to(cuda), [o.to(cuda) for o in ops]
    if kernel == "cell":
        h = h0.to(cuda, torch.bfloat16)
        whole = gru_cell(x, h, *ops)
        parts = torch.cat([gru_cell(x[i:i + 50], h[i:i + 50], *ops) for i in range(0, 1500, 50)])
        assert torch.equal(whole, parts)
    else:
        h = h0.to(cuda)  # f32, not bf16-valued: the h_lo half works too
        whole = gru_scan(x[None], h, *ops)
        parts = [gru_scan(x[None, i:i + 50], h[i:i + 50], *ops) for i in range(0, 1500, 50)]
        for k in range(len(whole)):
            assert torch.equal(whole[k], torch.cat([p[k] for p in parts], dim=1)), k


@pytest.mark.cuda
def test_gru_plan_is_the_kernels_on_card(cuda):
    """The C source's plan (``dt_gru_plan``) is ``gru_plan`` at every form
    the path and the tests launch; the wrappers refuse a shape where not."""
    for n, t, i, h in ((1, 1, 1027, 600), (50, 1, 1027, 600), (64, 1, 1027, 600),
                       (65, 1, 1027, 600), (1500, 1, 1027, 600), (50, 30, 1027, 600),
                       (10, 5, 37, 29), (3, 1, 13, 11)):
        for scan in (False, True):
            if t > 1 and not scan:
                continue
            gru_cuda._plans.pop((n, t, i, h, scan), None)
            assert gru_cuda.checked_plan(n, t, i, h, scan) == gru_cuda.gru_plan(n, t, i, h, scan)


@pytest.mark.cuda
def test_float32_is_refused_on_card(cuda):
    x, hh, ops = gru_operands()
    with pytest.raises(TypeError, match="bfloat16"):
        gru_cell(x.to(cuda), hh.to(cuda), *[o.to(cuda) for o in ops])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,steps", [("small", 4, 6), ("flagship", 50, 30),
                                           ("drone", 128, 30)])
def test_imagine_kernel_matches_plain_per_step_on_card(cuda, shape, n, steps):
    """The whole rollout on the card held step by step
    (``imagine_cuda.hold_rollout``: relaunched at T = 1 from its own states,
    equal bit for bit, and held to the plain step), then the plain rollout's
    states as one T = 1 launch (``hold_steps``)."""
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands(shape, n, steps)
    h0, z0, eps, gum = (v.to(cuda) for v in (h0, z0, eps, gum))
    w = [v.to(cuda) for v in w]
    before = imagine_rollout.launches
    out = imagine_rollout(h0, z0, eps, gum, w, unimix, min_std)
    torch.cuda.synchronize()
    assert imagine_rollout.launches == before + 1
    assert all(bool(torch.isfinite(o).all()) for o in out)
    stats = imagine_cuda.hold_rollout(out, eps, gum, w, unimix, min_std)
    assert stats["failures"] == [] and stats["carry_mismatches"] == 0, stats
    ref = imagine_rollout_plain(h0, z0, eps, gum, w, unimix, min_std)
    stats = imagine_cuda.hold_steps(ref[2], ref[3], eps, gum, w, unimix, min_std)[0]
    assert stats["failures"] == [], stats


def _launch_parts(args, w, unimix, min_std, parts):
    """One rollout as ``parts`` launches over consecutive slices of its rows,
    the outputs joined back along the rows."""
    h0, z0, eps, gum = args
    n = h0.shape[0] // parts
    outs = [imagine_rollout(h0[i:i + n], z0[i:i + n], eps[:, i:i + n].contiguous(),
                            gum[:, i:i + n].contiguous(), w, unimix, min_std)
            for i in range(0, h0.shape[0], n)]
    return tuple(torch.cat([o[k] for o in outs], dim=0 if k < 2 else 1) for k in range(7))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["steps", "rollout"])
def test_imagine_rows_do_not_depend_on_their_launch_on_card(cuda, form):
    """Bit for bit: 1500 rows at T = 1 (``hold_steps``' launch) against 30
    launches of 50, and a B 50 x T 30 rollout against two launches of 25
    rows.  Each output's sums do not depend on which rows share its launch,
    as ``hold_rollout`` needs."""
    n, steps = (1500, 1) if form == "steps" else (50, 30)
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands(
        "flagship", n, steps, seed=5)
    args = [v.to(cuda).contiguous() for v in (h0, z0, eps, gum)]
    w = [v.to(cuda) for v in w]
    whole = imagine_rollout(*args, w, unimix, min_std)
    parts = _launch_parts(args, w, unimix, min_std, 30 if form == "steps" else 2)
    for k, name in enumerate(imagine_cuda.NAMES):
        assert torch.equal(whole[k], parts[k]), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,blocks", [("flagship", 66), ("flagship", 1), ("drone", 50)])
def test_imagine_block_count_does_not_change_bits_on_card(cuda, shape, blocks):
    """The same rollout over fewer blocks than SMs, bit for bit: at 66
    blocks the flagship's slices still stay in shared memory, at one block
    and at the drone's widths over 50 they do not fit and each pass copies
    its weights in again.  Each launch's record shows every block of its
    plan run, each on an SM of its own, through every barrier of the 30
    steps."""
    n = 128 if shape == "drone" else 50
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands(shape, n, 30, seed=6)
    args = [v.to(cuda) for v in (h0, z0, eps, gum)]
    w = [v.to(cuda) for v in w]
    plan = imagine_cuda.imagine_plan(imagine_cuda.widths_of(
        imagine_cuda.dims_of(w, *args[:2], args[2]), rows, classes), blocks)
    assert plan.stationary == ((shape, blocks) == ("flagship", 66))
    sms = imagine_cuda.sm_count(args[0].device)
    whole, record = imagine_cuda._launch(*args, w, unimix, min_std, sms)
    fewer, fewer_record = imagine_cuda._launch(*args, w, unimix, min_std, blocks)
    for nb, rec in ((sms, record), (blocks, fewer_record)):
        got = imagine_cuda.launch_record(rec)
        assert (got["blocks"], got["sms"]) == (nb, nb), got
        assert got["count"] == nb * imagine_cuda.BARRIERS_PER_STEP * 30, got
    for k, name in enumerate(imagine_cuda.NAMES):
        assert torch.equal(whole[k], fewer[k]), name


@pytest.mark.cuda
def test_imagine_plan_is_the_kernels_on_card(cuda):
    """The C source's plan (``dt_imagine_plan``) is ``imagine_plan`` at the
    small, flagship and drone widths over 1, 50, 114 and 132 blocks; the
    wrapper refuses a shape where not."""
    for shape in ("small", "flagship", "drone"):
        h0, z0, eps, gum, w, rows, classes, _, _ = imagine_operands(shape, 2, 1)
        widths = imagine_cuda.widths_of(imagine_cuda.dims_of(w, h0, z0, eps), rows, classes)
        for blocks in (1, 50, 114, 132):
            assert imagine_cuda.c_plan_table(widths, blocks) == \
                imagine_cuda.imagine_plan(widths, blocks).table, (shape, blocks)


@pytest.mark.cuda
def test_imagine_refuses_float32_and_wide_rows_on_card(cuda):
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands(
        "small", dtype=torch.float32)
    args = [v.to(cuda) for v in (h0, z0, eps, gum)]
    with pytest.raises(TypeError, match="bfloat16"):
        imagine_rollout(*args, [v.to(cuda) for v in w], unimix, min_std)
    h0, z0, eps, gum, w, rows, classes, unimix, min_std = imagine_operands("small")
    wide = gum.reshape(*gum.shape[:2], 2, 64).to(cuda)  # 64 classes: more than a warp
    with pytest.raises(TypeError, match="32 classes"):
        imagine_rollout(*args[:3], wide.contiguous(), [v.to(cuda) for v in w], unimix, min_std)
