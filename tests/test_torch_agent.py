"""The port's actor-critic update (``train.agent.AgentTrainer.ac_update``)
against the JAX package's ``AgentTrainer.ac_update`` (jitted, the XLA fused
scans), at the SMALL config of tests/test_imagine_pallas.py with B = 4,
sequence length 8 (so a warm start of 4 frames), horizon 6, float32.

Both start from the same actor, critic, target critic, AdamW states and
return scale (carried across by ``bridge.load_ac_state``), read the same
batch, and draw the same noise: the test splits the JAX key as ``ac_loss``
and ``warm_start``/``_imagine_fused`` do and hands the port the gumbels and
normals JAX draws.  Two consecutive updates are compared, then a skipped
(non-finite) update, then a warm start across episode starts.

Tolerances: every metric to 1e-4 rel + 1e-5 abs; the updated parameters,
target critic and AdamW moments to 1e-5 rel + 1e-6 abs; the step counts and
the NaN skip exactly.  The losses are means over B*H terms computed in
float32 in another order, and the gradients go through six recurrent steps
(measured: 6.4e-6 rel on the metrics, 2.4e-7 abs on the parameters, 5.7e-7
abs on AdamW moments of up to 0.4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_ac_world, port_ac_state, small_configs, t
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
from dreamer_tpu_torch.rssm import RSSM
from dreamer_tpu_torch.train import ACNoise, AgentTrainer, Trainer

B, TW, A = 4, 4, 3
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def world():
    """The JAX program and the port's, on the same world model and initial
    state."""
    jcfg, cfg = small_configs()
    wm, jstate, jupdate = jax_ac_world(jcfg)
    rssm = RSSM(cfg.wm, A)
    bridge.load_wm(rssm.nets, wm)
    rssm.nets.requires_grad_(False)
    return dict(cfg=cfg, wm=wm, jstate=jstate, jupdate=jupdate, rssm=rssm,
                agent=AgentTrainer(cfg))


def port_state(w, jstate):
    return port_ac_state(w["cfg"], jstate)


def jax_noise(cfg, key):
    """The noise ``ac_loss`` draws from ``key``: k_warm, k_dream = split(key);
    the warm start's first sample from split(k_warm)[0], its steps from
    split(split(k_warm)[1], Tw - 1); the dream's eps and gumbels from the
    two halves of split(split(k_dream, H)[t])."""
    c, H = cfg.wm, cfg.train.horizon
    lat = (B, c.latent_rows, c.latent_classes)
    k_warm, k_dream = jax.random.split(key)
    key0, key_scan = jax.random.split(k_warm)
    warm = [jax.random.gumbel(key0, lat)] + [jax.random.gumbel(k, lat) for k in
                                            jax.random.split(key_scan, TW - 1)]
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_dream, H))
    eps = jax.vmap(lambda k: jax.random.normal(k, (B, A)))(pairs[:, 0])
    gum = jax.vmap(lambda k: jax.random.gumbel(k, lat))(pairs[:, 1])
    return ACNoise(t(jnp.stack(warm)), t(eps), t(gum))


def make_batch(cfg, rng, firsts=False, nan=False):
    obs = rng.integers(0, 256, (B, TW, *cfg.wm.obs_size, 3), dtype=np.uint8)
    actions = rng.uniform(-1, 1, (B, TW, A)).astype(np.float32)
    if nan:
        actions[1, 0, 0] = np.nan  # row 1's first warm-start step
    batch = [obs, actions]
    if firsts:
        f = np.zeros((B, TW), np.float32)
        f[0, 2] = f[2, 1] = f[3, 0] = 1.0  # the one at t = 0 is ignored
        batch += [rng.normal(size=(B, TW)).astype(np.float32),
                  np.ones((B, TW), np.float32), f]
    return batch


def same_metrics(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)


def same_state(port_state_, jstate):
    got = bridge.export_ac_state(port_state_)
    j = jax.tree.map(np.asarray, jstate)

    def trees(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                trees(a[k], b[k], f"{where}/{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=where)

    for name in ("actor_params", "critic_params", "target_critic_params"):
        trees(got[name], getattr(j, name), name)
    for name in ("actor_opt", "critic_opt"):
        adam = bridge._adam_of(getattr(j, name))
        assert got[name]["count"] == int(adam.count), name
        trees(got[name]["mu"], adam.mu, f"{name}/mu")
        trees(got[name]["nu"], adam.nu, f"{name}/nu")
    np.testing.assert_allclose(got["s_scale"], j.s_scale, rtol=STATE_RTOL, atol=STATE_ATOL)


def run_both(w, jstate, pstate, batch, key):
    jstate, jm = w["jupdate"](jstate, w["wm"], tuple(map(jnp.asarray, batch)), key)
    before = imagine_rollout.launches
    pstate, pm = w["agent"].ac_update(pstate, w["rssm"], [t(b) for b in batch],
                                      jax_noise(w["cfg"], key))
    assert imagine_rollout.launches == before  # the CPU takes the plain version
    return jstate, jax.tree.map(np.asarray, jm), pstate, pm


def test_load_ac_state_round_trips(world):
    w = world
    pstate = port_state(w, w["jstate"])
    same_state(pstate, w["jstate"])


def test_two_updates_match(world):
    w = world
    rng = np.random.default_rng(1)
    jstate, pstate = w["jstate"], port_state(w, w["jstate"])
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm, pstate, pm = run_both(w, jstate, pstate, make_batch(w["cfg"], rng), key)
        assert float(jm["ac/update_skipped"]) == 0.0
        same_metrics(pm, jm)
        same_state(pstate, jstate)


def test_a_non_finite_update_is_skipped(world):
    w = world
    rng = np.random.default_rng(2)
    jstate, pstate = w["jstate"], port_state(w, w["jstate"])
    before = bridge.export_ac_state(pstate)
    jstate, jm, pstate, pm = run_both(w, jstate, pstate, make_batch(w["cfg"], rng, nan=True),
                                      jax.random.PRNGKey(20))
    assert float(jm["ac/update_skipped"]) == 1.0 == float(pm["ac/update_skipped"])
    assert np.isnan(float(pm["ac/loss_actor"])) and np.isnan(float(jm["ac/loss_actor"]))
    same_metrics(pm, jm)
    same_state(pstate, jstate)
    after = bridge.export_ac_state(pstate)
    assert after["actor_opt"]["count"] == before["actor_opt"]["count"] == 0
    np.testing.assert_array_equal(after["actor_params"]["Dense_0"]["kernel"],
                                  before["actor_params"]["Dense_0"]["kernel"])


def test_warm_start_across_episode_starts(world):
    w = world
    rng = np.random.default_rng(3)
    jstate, pstate = w["jstate"], port_state(w, w["jstate"])
    batch = make_batch(w["cfg"], rng, firsts=True)
    jstate, jm, pstate, pm = run_both(w, jstate, pstate, batch, jax.random.PRNGKey(30))
    same_metrics(pm, jm)
    same_state(pstate, jstate)
    # The reset changes the warm start's end state: without the channel the
    # metrics differ.
    _, jm2 = w["jupdate"](w["jstate"], w["wm"], tuple(map(jnp.asarray, batch[:2])),
                          jax.random.PRNGKey(30))
    assert float(jm2["ac/value_mean"]) != float(jm["ac/value_mean"])


def test_analytic_entropy_conts_resets_and_a_traced_nu():
    """The other flags of ``ac_loss``: the base Normal's analytic entropy, the
    warm start's resets derived from the continue flags under
    ``wm.reset_on_episode_start``, and an entropy coefficient passed as a
    tensor."""
    jcfg, cfg = small_configs()
    for c in (jcfg, cfg):
        c.agent.analytic_entropy = True
        c.wm.reset_on_episode_start = True
    wm, jstate, jupdate = jax_ac_world(jcfg, seed=4)
    rssm = RSSM(cfg.wm, A)
    bridge.load_wm(rssm.nets, wm)
    rssm.nets.requires_grad_(False)
    rng = np.random.default_rng(4)
    batch = make_batch(cfg, rng)
    conts = np.ones((B, TW), np.float32)
    conts[0, 1] = conts[2, 0] = 0.0  # episodes end there: resets at t = 2 and t = 1
    batch += [rng.normal(size=(B, TW)).astype(np.float32), conts]
    key, nu = jax.random.PRNGKey(40), 0.05
    pstate = port_ac_state(cfg, jstate)
    jstate, jm = jupdate(jstate, wm, tuple(map(jnp.asarray, batch)), key, jnp.float32(nu))
    pstate, pm = AgentTrainer(cfg).ac_update(pstate, rssm, [t(b) for b in batch],
                                             jax_noise(cfg, key), nu=torch.tensor(nu))
    same_metrics(pm, jax.tree.map(np.asarray, jm))
    same_state(pstate, jstate)


def test_trainer_ac_step_on_the_cpu():
    """``Trainer.ac_step`` on a ``DreamerState``: two updates on fresh
    samples of a filled ring, metrics averaged, the target moved by tau toward
    the critic, no kernel launched on the CPU."""
    _, cfg = small_configs()
    trainer = Trainer(cfg, device="cpu", seed=0)
    state = trainer.init_state()
    ring = trainer.buffer.init_state()
    g = torch.Generator().manual_seed(0)
    n = 24
    trainer.buffer.add_batch(
        ring, torch.randint(0, 256, (1, n, *cfg.wm.obs_size, 3), dtype=torch.uint8, generator=g),
        torch.rand(1, n, A, generator=g) * 2 - 1, torch.randn(1, n, generator=g),
        torch.ones(1, n))
    ac = state.ac
    critic0 = [p.detach().clone() for p in ac.critic.parameters()]
    target0 = [p.detach().clone() for p in ac.target_critic.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(critic0, target0))
    before = imagine_rollout.launches
    state, metrics = trainer.ac_step(state, ring, g)
    assert imagine_rollout.launches == before
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["ac/update_skipped"]) == 0.0
    assert int(ac.actor_opt.count) == int(ac.critic_opt.count) == cfg.train.ac_epochs
    assert float(ac.s_scale) != 1.0
    # After two soft updates from equal start: t2 = (1-tau)^2 c0 + tau (1-tau) c1 + tau c2,
    # so t2 lies strictly between c0 and the new critic, near c0.
    tau = cfg.agent.target_tau
    for c0, c2, t2 in zip(critic0, ac.critic.parameters(), ac.target_critic.parameters()):
        moved = (t2 - c0).abs().max()
        assert float(moved) <= 2 * tau * float((c2.detach() - c0).abs().max()) + 1e-7
    assert any(not torch.equal(c0, c2) for c0, c2 in zip(critic0, ac.critic.parameters()))
    # The actor-critic half leaves the world model and the step as they were.
    assert int(state.wm.opt.count) == 0 and int(state.step) == 0
