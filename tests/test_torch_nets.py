"""The port's nets and the plain versions of its kernels against the JAX
package, at configs/fake_smoke.yaml widths, on inputs made with numpy.

Tolerances:
- float32: 1e-5 abs/rel.  Both sides compute in float32 and differ only in
  the order of the sums (measured: under 1e-6).
- bfloat16 against the Pallas kernels: 1e-2 abs/rel, one bf16 step.  The port
  does the kernels' arithmetic (f32 accumulation, f32 gate math, each output
  rounded to bf16 once); only the summation order may differ (measured: 0).
- bfloat16 against the flax/XLA path: 2e-2 abs/rel.  XLA rounds to bf16 after
  each dot, bias add and activation, where the port rounds once, so values up
  to 2 may differ by one bf16 step of 2**-6 (measured: 0.0078).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import DTYPES, configs, f32, jax_params, port_nets, random_like, t
from dreamer_tpu.nets.actor_critic import Actor as JaxActor
from dreamer_tpu.nets.gru import gru_cell_core as jax_gru_cell_core
from dreamer_tpu.nets.mlp import MLP as JaxMLP
from dreamer_tpu.nets.wm_nets import WMNets as JaxWMNets
from dreamer_tpu.ops.conv_pallas import encoder_forward as pallas_encoder_forward
from dreamer_tpu.ops.gru_pallas import gru_cell_pallas
from dreamer_tpu_torch.nets.gru import gru_cell_core
from dreamer_tpu_torch.nets.mlp import MLP, LayerNorm
from dreamer_tpu_torch.ops.conv_cuda import (encoder_forward_plain, encoder_kernel_layout,
                                             norm_table)
from dreamer_tpu_torch.ops.gru_cuda import gru_cell_plain, gru_kernel_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
TOL_F32 = 1e-5
TOL_KERNEL_BF16 = 1e-2
TOL_XLA_BF16 = 2e-2
DTYPE_NAMES = ["float32", "bfloat16"]


def close(port, ref, tol):
    np.testing.assert_allclose(f32(port), f32(ref), rtol=tol, atol=tol)


def xla_tol(dtype):
    return TOL_F32 if dtype == "float32" else TOL_XLA_BF16


def kernel_tol(dtype):
    return TOL_F32 if dtype == "float32" else TOL_KERNEL_BF16


@pytest.fixture(scope="module", params=DTYPE_NAMES)
def setup(request):
    """(dtype name, JAX config, port config, JAX nets, wm tree, actor tree,
    port nets, port actor)."""
    jcfg, cfg = configs(SMOKE, request.param)
    wm, actor_tree = jax_params(jcfg)
    nets, actor = port_nets(cfg, wm, actor_tree)
    jnets = JaxWMNets(jcfg.wm, dtype=DTYPES[request.param][0])
    return request.param, jcfg, cfg, jnets, wm, actor_tree, nets, actor


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_layer_norm_matches_flax(dtype, rng):
    jd, td = DTYPES[dtype]
    # A large mean exercises flax's fast variance E[x^2] - E[x]^2.
    x = (rng.standard_normal((8, 37)) * 2 + 3).astype(np.float32)
    scale = rng.standard_normal(37).astype(np.float32)
    bias = rng.standard_normal(37).astype(np.float32)
    ref = fnn.LayerNorm(epsilon=1e-5, dtype=jd).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x).astype(jd))
    ln = LayerNorm(37, td)
    with torch.no_grad():
        ln.scale.copy_(t(scale))
        ln.bias.copy_(t(bias))
    close(ln(t(x).to(td)), ref, kernel_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_mlp_matches_flax(dtype, rng):
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((5, 12)).astype(np.float32)
    jm = JaxMLP([16, 24], 10, dtype=jd)
    params = random_like(jax.eval_shape(jm.init, jax.random.PRNGKey(3), jnp.asarray(x)),
                         rng)["params"]
    m = MLP(12, [16, 24], 10, td)
    with torch.no_grad():
        for i, d in enumerate(m.denses):
            d.weight.copy_(t(params[f"Dense_{i}"]["kernel"]).T)
            d.bias.copy_(t(params[f"Dense_{i}"]["bias"]))
        for i, n in enumerate(m.norms):
            n.scale.copy_(t(params[f"LayerNorm_{i}"]["scale"]))
            n.bias.copy_(t(params[f"LayerNorm_{i}"]["bias"]))
    close(m(t(x)), jm.apply({"params": params}, jnp.asarray(x)), xla_tol(dtype))


def test_actor_matches_flax(setup, rng):
    dtype, jcfg, cfg, _, _, actor_tree, _, actor = setup
    a = jcfg.agent
    jactor = JaxActor(action_dim=jcfg.env.action_dim, hidden_1=a.actor_hidden_1,
                      hidden_2=a.actor_hidden_2, min_std=a.min_std, dtype=DTYPES[dtype][0])
    h = rng.standard_normal((7, jcfg.wm.hidden_dim)).astype(np.float32)
    z = rng.standard_normal((7, jcfg.wm.latent_dim)).astype(np.float32)
    mu, sigma = jactor.apply({"params": actor_tree}, jnp.asarray(h), jnp.asarray(z))
    pmu, psigma = actor(t(h), t(z))
    assert pmu.dtype == psigma.dtype == torch.float32
    close(pmu, mu, xla_tol(dtype))
    close(psigma, sigma, xla_tol(dtype))


def test_posterior_logits_matches_flax(setup, rng):
    dtype, jcfg, _, jnets, wm, _, nets, _ = setup
    feat = rng.standard_normal((6, nets.feat_dim)).astype(np.float32)
    h = rng.standard_normal((6, jcfg.wm.hidden_dim)).astype(np.float32)
    ref = jnets.apply({"params": wm}, jnp.asarray(feat).astype(jnets.dtype), jnp.asarray(h),
                      method=JaxWMNets.posterior_logits)
    out = nets.posterior_logits(t(feat), t(h))
    assert out.shape == ref.shape == (6, jcfg.wm.latent_rows, jcfg.wm.latent_classes)
    close(out, ref, xla_tol(dtype))


def _gru_inputs(rng, n=10, i=37, h=29):
    scale = 1.0 / np.sqrt(h)
    return (rng.standard_normal((n, i)).astype(np.float32),
            rng.standard_normal((n, h)).astype(np.float32),
            rng.uniform(-scale, scale, (i, 3 * h)).astype(np.float32),
            rng.uniform(-scale, scale, (h, 3 * h)).astype(np.float32),
            rng.uniform(-scale, scale, (3 * h,)).astype(np.float32),
            rng.uniform(-scale, scale, (3 * h,)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
def test_gru_plain_matches_core(dtype, rng):
    jd, td = DTYPES[dtype]
    args = _gru_inputs(rng)
    ref = jax_gru_cell_core(*(jnp.asarray(a).astype(jd) for a in args))
    x, h, wi, wh, bi, bh = (t(a).to(td) for a in args)
    close(gru_cell_core(x, h, wi, wh, bi, bh), ref, xla_tol(dtype))
    close(gru_cell_plain(x, h, *gru_kernel_layout(wi, wh, bi, bh, td)), ref, xla_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPE_NAMES)
@pytest.mark.parametrize("n,i,h", [(10, 37, 29), (16, 67, 64)])
def test_gru_plain_matches_pallas_interpret(dtype, n, i, h, rng):
    jd, td = DTYPES[dtype]
    args = _gru_inputs(rng, n, i, h)
    with pltpu.force_tpu_interpret_mode():
        ref = gru_cell_pallas(*(jnp.asarray(a).astype(jd) for a in args))
    x, hh, wi, wh, bi, bh = (t(a) for a in args)
    out = gru_cell_plain(x.to(td), hh.to(td), *gru_kernel_layout(wi, wh, bi, bh, td))
    assert out.dtype == td
    close(out, ref, kernel_tol(dtype))


def test_gru_step_matches_flax(setup, rng):
    dtype, jcfg, _, jnets, wm, _, nets, _ = setup
    c = jcfg.wm
    z = rng.standard_normal((6, c.latent_dim)).astype(np.float32)
    a = rng.uniform(-1, 1, (6, jcfg.env.action_dim)).astype(np.float32)
    h = rng.standard_normal((6, c.hidden_dim)).astype(np.float32)
    ref = jnets.apply({"params": wm}, jnp.asarray(z), jnp.asarray(a), jnp.asarray(h),
                      method=JaxWMNets.gru_step)
    close(nets.gru_step(t(z), t(a), t(h)), ref, xla_tol(dtype))


def test_gru_cell_module_matches_pallas(setup, rng):
    dtype, jcfg, _, _, wm, _, nets, _ = setup
    g = wm["gru"]
    x = rng.standard_normal((9, g["kernel_i"].shape[0])).astype(np.float32)
    h = rng.standard_normal((9, jcfg.wm.hidden_dim)).astype(np.float32)
    jd = DTYPES[dtype][0]
    with pltpu.force_tpu_interpret_mode():
        ref = gru_cell_pallas(*(jnp.asarray(a).astype(jd) for a in (
            x, h, g["kernel_i"], g["kernel_h"], g["bias_i"], g["bias_h"])))
    close(nets.gru(t(x), t(h)), ref, kernel_tol(dtype))


def _frames(rng, n, cfg):
    return rng.integers(0, 256, (n, *cfg.wm.obs_size, 3), dtype=np.uint8)


@pytest.mark.parametrize("n", [1, 5])
def test_encoder_plain_matches_flax(setup, rng, n):
    dtype, jcfg, _, jnets, wm, _, nets, _ = setup
    obs = _frames(rng, n, jcfg)
    ref = jnets.apply({"params": wm}, jnp.asarray(obs, jnp.float32) / 255.0 - 0.5,
                      method=JaxWMNets.encode_obs)
    out = nets.encode_obs(t(obs))
    assert out.shape == (n, nets.feat_dim)
    close(out, ref, xla_tol(dtype))


@pytest.mark.parametrize("n,block", [(7, 4), (3, 8)])
def test_encoder_plain_matches_pallas_interpret(setup, rng, n, block):
    dtype, jcfg, _, _, wm, _, nets, _ = setup
    obs = _frames(rng, n, jcfg)
    ws = [jnp.asarray(wm[f"enc_conv{i}"]["kernel"]) for i in range(4)]
    bs = [jnp.asarray(wm[f"enc_conv{i}"]["bias"]) for i in range(4)]
    ref = pallas_encoder_forward(jnp.asarray(obs), ws, bs, dtype=DTYPES[dtype][0],
                                 block=block, interpret=True)
    pw, pb = encoder_kernel_layout([c.weight for c in nets.enc_convs],
                                   [c.bias for c in nets.enc_convs], DTYPES[dtype][1])
    # The Pallas kernel normalises as serving does (conv_pallas.py:101-102).
    table = norm_table("serve", DTYPES[dtype][1])
    close(encoder_forward_plain(t(obs), pw, pb, table), ref, kernel_tol(dtype))


def test_encoder_flattens_in_hwc_order(rng):
    """A feature's index is (y * W + x) * C + c, as the posterior head's
    weight rows expect: one channel set at one output pixel lights one index."""
    jcfg, cfg = configs(SMOKE, "float32")
    wm, actor_tree = jax_params(jcfg)
    nets, _ = port_nets(cfg, wm, actor_tree)
    obs = _frames(rng, 2, cfg)
    feat = nets.encode_obs(t(obs))
    ws, bs = nets.encoder_weights()
    x = (t(obs).float() / 255.0 - 0.5).permute(0, 3, 1, 2)
    for w, b in zip(ws, bs):
        x = torch.nn.functional.silu(torch.nn.functional.conv2d(
            x, w.permute(3, 2, 0, 1), b, stride=2, padding=1))
    n, c, hh, ww = x.shape
    for y, xx, ch in [(0, 0, 0), (hh - 1, ww - 1, c - 1), (hh - 1, 0, 3)]:
        assert torch.allclose(feat[:, (y * ww + xx) * c + ch], x[:, ch, y, xx], atol=1e-6)
