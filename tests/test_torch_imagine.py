"""The port's imagination (``ops.imagine_cuda`` plain version and
``ops.imagine_scan``) against the JAX package's, at the SMALL config of
tests/test_imagine_pallas.py (GRU 64, 8x16 latents, hiddens 24), B = 4,
horizon 6, float32, from the same parameters and noise made with numpy:

- the forward against ``imagine_scan_pallas`` (the Pallas kernel in
  interpret mode, as tests/test_imagine_pallas.py runs it) and against the
  XLA ``imagine_scan``: sampled categories equal, every output to 1e-5
  abs/rel (float32 sums in another order; measured under 1e-6);
- every gradient of a weighted sum of all seven outputs, with respect to the
  GRU, dynamics-head and actor parameters and (h0, z0), against
  ``jax.grad`` of the XLA scan: to 1e-4 rel + 1e-5 abs (the backward sums
  over T*B in another order, through 6 recurrent steps; measured: at most
  6.7e-6 abs).

Then the kernel's acceptance check (``imagine_cuda.compare_step``, with the
tolerances stated beside it) at the flagship widths in bfloat16: it holds a
step against itself and fails a step without unimix, without a LayerNorm
bias, or with the straight-through value computed as onehot + (p - p)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_parity import SMALL, f32, random_like, t
from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.config import WorldModelConfig as JaxWMConfig
from dreamer_tpu.ops.fused_scans import _ImagineCfg, imagine_scan, imagine_scan_pallas
from dreamer_tpu.rssm import RSSM as JaxRSSM
from dreamer_tpu.train.agent import AgentTrainer as JaxAgentTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig, WorldModelConfig
from dreamer_tpu_torch.nets import Actor, WMNets
from dreamer_tpu_torch.ops import imagine_cuda
from dreamer_tpu_torch.ops.imagine_cuda import (compare_step, imagine_rollout,
                                                imagine_rollout_plain, imagine_step)
from dreamer_tpu_torch.ops.imagine_scan import imagine_scan as port_imagine_scan
from dreamer_tpu_torch.ops.imagine_scan import scan_params

ROWS, CLASSES, B, T, A, MIN_STD = 8, 16, 4, 6, 3, 0.1
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
PRIOR_SCALE = 8.0
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "car_racer.yaml")


def noise(rng, b=B, steps=T, rows=ROWS, classes=CLASSES):
    eps = rng.standard_normal((steps, b, A)).astype(np.float32)
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (steps, b, rows, classes))
    return eps, (-np.log(-np.log(u))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    jwm = JaxWMConfig(**SMALL)
    jcfg = JaxConfig()
    jcfg.wm = jwm
    jcfg.agent.actor_hidden_1 = jcfg.agent.actor_hidden_2 = 24
    wm = random_like(jax.eval_shape(JaxRSSM(jwm, A).init_params, key), rng)
    actor, _ = jax.eval_shape(lambda k: JaxAgentTrainer(jcfg).init_params(
        k, jwm.hidden_dim, jwm.latent_dim), key)
    actor = random_like(actor, rng)
    nets = WMNets(WorldModelConfig(**SMALL), A)
    bridge.load_wm(nets, wm)
    port_actor = Actor(jwm.hidden_dim + jwm.latent_dim, A, 24, 24, MIN_STD)
    bridge.load_actor(port_actor, actor)
    h0 = np.tanh(rng.standard_normal((B, jwm.hidden_dim))).astype(np.float32)
    z0 = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (B, ROWS))].reshape(B, -1)
    eps, gum = noise(rng)
    icfg = _ImagineCfg(horizon=T, unimix=jwm.unimix, latent_dim=jwm.latent_dim, rows=ROWS,
                       classes=CLASSES, dtype=jnp.float32, unroll=1, min_std=MIN_STD)
    sub = {"gru": wm["gru"], "dyn": wm["dyn_head"], "actor": actor}
    return dict(icfg=icfg, sub=sub, nets=nets, actor=port_actor, h0=h0, z0=z0, eps=eps,
                gum=gum, unimix=jwm.unimix)


def cats(z):
    return np.asarray(f32(z)).reshape(-1, ROWS, CLASSES).argmax(-1)


def check_forward(port, ref):
    np.testing.assert_array_equal(cats(port[1]), cats(ref[1]))
    np.testing.assert_array_equal(cats(port[3][1:]), cats(ref[3][1:]))
    for name, p, r in zip(imagine_cuda.NAMES, port, ref):
        np.testing.assert_allclose(f32(p), f32(r), rtol=TOL, atol=TOL, err_msg=name)


def port_forward(s):
    weights = (*s["actor"].imagine_weights(), *s["nets"].imagine_weights())
    return imagine_rollout(t(s["h0"]), t(s["z0"]), t(s["eps"]), t(s["gum"]), weights,
                           s["unimix"], MIN_STD)


def test_forward_matches_pallas_interpret(setup):
    s = setup
    before = imagine_rollout.launches
    port = port_forward(s)
    assert imagine_rollout.launches == before  # the CPU takes the plain version
    with pltpu.force_tpu_interpret_mode():
        ref = imagine_scan_pallas(s["icfg"], s["sub"], *map(jnp.asarray, (
            s["h0"], s["z0"], s["eps"], s["gum"])))
    check_forward(port, ref)


def test_forward_and_all_gradients_match_the_xla_scan(setup):
    s = setup
    rng = np.random.default_rng(5)
    args = [jnp.asarray(s[k]) for k in ("h0", "z0", "eps", "gum")]
    ref = imagine_scan(s["icfg"], s["sub"], *args)
    weights = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in ref]

    def jax_loss(sub, h0, z0):
        out = imagine_scan(s["icfg"], sub, h0, z0, args[2], args[3])
        return sum(jnp.sum(w * o) for w, o in zip(weights, out))

    g_sub, g_h0, g_z0 = jax.grad(jax_loss, argnums=(0, 1, 2))(s["sub"], args[0], args[1])

    params = scan_params(s["actor"], s["nets"])
    h0 = t(s["h0"]).requires_grad_()
    z0 = t(s["z0"]).requires_grad_()
    port = port_imagine_scan(s["actor"], s["nets"], h0, z0, t(s["eps"]), t(s["gum"]),
                             s["unimix"], MIN_STD)
    check_forward(port, ref)
    loss = sum((t(w) * o).sum() for w, o in zip(weights, port))
    grads = torch.autograd.grad(loss, params + [h0, z0])

    close = lambda a, b, msg: np.testing.assert_allclose(  # noqa: E731
        a, np.asarray(b), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=msg)
    close(f32(grads[-2]), g_h0, "h0")
    close(f32(grads[-1]), g_z0, "z0")
    entries = {id(p): (("actor",) + path, to_flax)
               for path, p, _, to_flax in bridge._actor_entries(s["actor"])}
    entries.update({id(p): (("dyn",) + path[1:] if path[0] == "dyn_head" else path, to_flax)
                    for path, p, _, to_flax in bridge._wm_entries(s["nets"])})
    for p, g in zip(params, grads[:-2]):
        path, to_flax = entries[id(p)]
        node = g_sub
        for k in path:
            node = node[k]
        close(to_flax(f32(g)), node, "/".join(path))
    assert len(params) == 26


def test_only_the_asked_gradients_are_made(setup):
    """The world model frozen, as in the actor-critic update: the actor's
    gradients come back, and equal those of the full backward."""
    s = setup
    params = scan_params(s["actor"], s["nets"])
    for p in params[12:]:
        p.requires_grad_(False)
    try:
        out = port_imagine_scan(s["actor"], s["nets"], t(s["h0"]), t(s["z0"]), t(s["eps"]),
                                t(s["gum"]), s["unimix"], MIN_STD)
        part = torch.autograd.grad(out[5].sum() + out[6].sum(), params[:12])
    finally:
        for p in params[12:]:
            p.requires_grad_(True)
    out = port_imagine_scan(s["actor"], s["nets"], t(s["h0"]), t(s["z0"]), t(s["eps"]),
                            t(s["gum"]), s["unimix"], MIN_STD)
    full = torch.autograd.grad(out[5].sum() + out[6].sum(), params)
    for a, b in zip(part, full[:12]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The kernel's acceptance check, at the flagship widths in bfloat16
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def flagship_step():
    cfg = DreamerConfig.from_yaml(FLAGSHIP)
    c = cfg.wm
    g = torch.Generator().manual_seed(3)
    nets = WMNets(c, A, torch.bfloat16, g)
    actor = Actor(c.hidden_dim + c.latent_dim, A, 200, 200, cfg.agent.min_std,
                  torch.bfloat16, g)
    with torch.no_grad():  # the init leaves them zero; a dropped one must show
        for m in (nets, actor):
            for p in m.parameters():
                if not p.any():
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))
        # At init the prior is nearly flat (mean top probability 0.09), where
        # unimix hardly moves log p; x PRIOR_SCALE makes it as peaked as a
        # trained prior (mean top probability 0.69).
        nets.dyn_head.denses[2].weight.mul_(PRIOR_SCALE)
    weights = list((*actor.imagine_weights(), *nets.imagine_weights()))
    n = 64
    rng = np.random.default_rng(4)
    h = t(np.tanh(rng.standard_normal((n, c.hidden_dim))).astype(np.float32))
    z = t(np.eye(32, dtype=np.float32)[rng.integers(0, 32, (n, 32))].reshape(n, -1))
    eps, gum = noise(rng, n, 1, 32, 32)
    args = (h, z, t(eps[0]), t(gum[0]))
    ref = imagine_step(weights, *args, c.unimix, cfg.agent.min_std)
    return weights, args, ref, c.unimix, cfg.agent.min_std


def test_check_holds_a_step_against_itself(flagship_step):
    weights, args, ref, unimix, min_std = flagship_step
    stats = compare_step(ref, ref, 32, 32)
    assert stats["failures"] == [] and stats["rows"] == 64 * 32
    assert stats["residual_share"] > 2 * imagine_cuda.MIN_RESIDUAL_SHARE
    for name in ("h_next", "mu", "sigma", "action"):  # the tolerance is below the values
        v = getattr(ref, name)
        assert float(imagine_cuda.TOL) < 0.25 * float(v.abs().max())


@pytest.mark.parametrize("fault", ["no_unimix", "no_ln_bias", "ste_order"])
def test_check_fails_a_faulty_variant(flagship_step, fault):
    weights, args, ref, unimix, min_std = flagship_step
    if fault == "no_unimix":
        out = imagine_step(weights, *args, 0.0, min_std)
    elif fault == "no_ln_bias":
        w = list(weights)
        w[3] = torch.zeros_like(w[3])  # the actor's first LayerNorm bias
        out = imagine_step(w, *args, unimix, min_std)
    else:  # onehot + (p - p): the exact one-hot
        onehot = torch.nn.functional.one_hot(ref.scores.argmax(-1), 32).float()
        out = ref._replace(z_next=onehot.reshape(ref.z_next.shape))
    assert compare_step(out, ref, 32, 32)["failures"]


def test_plain_rollout_is_the_plain_steps(setup):
    s = setup
    weights = (*s["actor"].imagine_weights(), *s["nets"].imagine_weights())
    out = imagine_rollout_plain(t(s["h0"]), t(s["z0"]), t(s["eps"]), t(s["gum"]), weights,
                                s["unimix"], MIN_STD)
    h, z = t(s["h0"]), t(s["z0"])
    for step in range(T):
        st = imagine_step(weights, h, z, t(s["eps"][step]), t(s["gum"][step]), s["unimix"],
                          MIN_STD)
        assert torch.equal(out[2][step], h) and torch.equal(out[5][step], st.mu)
        h, z = st.h_next, st.z_next
    assert torch.equal(out[0], h) and torch.equal(out[1], z)


@pytest.mark.parametrize("case", ["count", "latent", "weight_dtype", "noise_dtype", "shape"])
def test_imagine_rollout_rejects_bad_operands(setup, case):
    s = setup
    weights = list((*s["actor"].imagine_weights(), *s["nets"].imagine_weights()))
    h0, z0, eps, gum = (t(s[k]) for k in ("h0", "z0", "eps", "gum"))
    if case == "count":
        weights = weights[:-1]
    elif case == "latent":
        gum = gum[..., :8].contiguous()
    elif case == "weight_dtype":
        weights[0] = weights[0].double()
    elif case == "noise_dtype":
        eps = eps.double()
    else:
        z0 = z0[:, :-8].contiguous()
    with pytest.raises((ValueError, TypeError)):
        imagine_rollout(h0, z0, eps, gum, weights, s["unimix"], MIN_STD)


def test_off_the_cpu_the_wrapper_launches_or_raises(setup):
    s = setup
    weights = [w.to("meta") for w in (*s["actor"].imagine_weights(),
                                      *s["nets"].imagine_weights())]
    before = imagine_rollout.launches
    with pytest.raises(TypeError, match="kernel takes"):
        imagine_rollout(*(t(s[k]).to("meta") for k in ("h0", "z0", "eps", "gum")), weights,
                        s["unimix"], MIN_STD)
    assert imagine_rollout.launches == before
