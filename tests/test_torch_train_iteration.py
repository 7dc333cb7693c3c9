"""The port's whole learner iteration (``train.step.Trainer.train_iteration``:
two world-model updates, then two actor-critic updates on the updated world
model, then step + 1) against the JAX package's ``Trainer.train_iteration``
(jitted), at the SMALL config of tests/test_imagine_pallas.py with B = 4,
sequence length 8, horizon 6, float32, over two iterations.

Both start from the same ``DreamerState`` (every parameter random, carried
across by ``bridge.load_dreamer_state``) and the same ring of 24 steps, and
the port is handed every draw JAX makes from its key: the (env, start) of
each sample and each update's noise, split as ``train_iteration``,
``wm_step``, ``ac_step`` and the losses split it.

Tolerances: every metric, the per-epoch WM losses included, to 1e-4 rel +
1e-5 abs; the world model's parameters to 1e-6 abs, a hundredth of its
learning rate, and its AdamW moments to 1e-5 rel + 1e-6 abs; the actor,
critic and target critic to 1e-6 abs, their AdamW moments to 1e-4 rel +
1e-5 abs and the return scale to 1e-5 rel; the step counts exactly.  The
actor-critic half reads a world model that already differs by up to 7e-8
after its update, and its gradients go through the dream: measured, the
parameters differ by at most 3.3e-7 and the first moments (a tenth of a
gradient) by 5.4e-6.

Then a JAX ``DreamerState`` after its iteration loads into the port and
comes back unchanged, and the CPU ``Trainer`` runs an iteration on its own
draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (WM_MOMENT_ATOL, WM_MOMENT_RTOL, WM_PARAM_ATOL, close_trees,
                           iteration_draws, jax_dreamer_world, port_dreamer_state,
                           same_wm_metrics, same_wm_state, small_configs, t)
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.ops import conv_cuda, gru_cuda, gru_scan_cuda, imagine_cuda
from dreamer_tpu_torch.train import Trainer

AC_PARAM_ATOL = 1e-6
AC_MOMENT_RTOL, AC_MOMENT_ATOL = 1e-4, 1e-5
AC_RTOL = 1e-5
STEPS = 24


def ring_data(cfg, rng):
    return [rng.integers(0, 256, (1, STEPS, *cfg.wm.obs_size, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (1, STEPS, cfg.env.action_dim)).astype(np.float32),
            (2.0 * rng.standard_normal((1, STEPS))).astype(np.float32),
            np.ones((1, STEPS), np.float32)]


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = small_configs()
    jtr, jstate = jax_dreamer_world(jcfg, seed=5)
    data = ring_data(cfg, np.random.default_rng(5))
    jring = jtr.buffer.add_batch(jtr.buffer.init_state(), *map(jnp.asarray, data))
    trainer = Trainer(cfg, device="cpu")
    ring = trainer.buffer.add_batch(trainer.buffer.init_state(), *map(t, data))
    return dict(jcfg=jcfg, cfg=cfg, jtr=jtr, jstate=jstate, jring=jring, trainer=trainer,
                ring=ring)


def scripted(trainer, draws):
    """Make ``trainer`` take JAX's draws, in order, instead of its generator's."""
    indices, wm_noise, ac_noise = (iter(d) for d in draws)
    trainer.buffer.draw_indices = lambda ring, batch_size, generator, n_shards=1: next(indices)
    trainer.sample_wm_noise = lambda batch_size, generator: next(wm_noise)
    trainer.sample_ac_noise = lambda batch_size, generator: next(ac_noise)


def same_ac_state(port, jac):
    got = bridge.export_ac_state(port)
    j = jax.tree.map(np.asarray, jac)
    for name in ("actor_params", "critic_params", "target_critic_params"):
        close_trees(got[name], getattr(j, name), 0.0, AC_PARAM_ATOL, name)
    for name in ("actor_opt", "critic_opt"):
        adam = bridge._adam_of(getattr(j, name))
        assert got[name]["count"] == int(adam.count), name
        for moment in ("mu", "nu"):
            close_trees(got[name][moment], getattr(adam, moment), AC_MOMENT_RTOL,
                        AC_MOMENT_ATOL, f"{name}/{moment}")
    np.testing.assert_allclose(got["s_scale"], j.s_scale, rtol=AC_RTOL)


def test_two_iterations_match(world):
    w = world
    trainer = w["trainer"]
    jstate, state = w["jstate"], port_dreamer_state(trainer, w["jstate"])
    kernels = (gru_cuda.gru_cell, gru_scan_cuda.gru_scan, conv_cuda.encoder_forward,
               imagine_cuda.imagine_rollout)
    before = [k.launches for k in kernels]
    for i in range(2):
        key = jax.random.PRNGKey(50 + i)
        scripted(trainer, iteration_draws(w["jtr"], w["jring"], key, w["jcfg"]))
        jstate, jm = w["jtr"].train_iteration(jstate, w["jring"], key)
        state, pm = trainer.train_iteration(state, w["ring"], torch.Generator())
        jm = jax.tree.map(np.asarray, jm)
        assert jm["wm/loss_epochs"].shape == (2,) == tuple(pm["wm/loss_epochs"].shape)
        assert float(pm["wm/update_skipped"]) == float(pm["ac/update_skipped"]) == 0.0
        same_wm_metrics(pm, jm)
        same_wm_state(state, jstate.wm, WM_PARAM_ATOL, WM_MOMENT_RTOL, WM_MOMENT_ATOL)
        same_ac_state(state.ac, jstate.ac)
        assert int(state.step) == int(jstate.step) == i + 1
    assert [k.launches for k in kernels] == before  # the CPU takes the plain versions
    w["jstate_after"] = jstate


def test_dreamer_state_round_trips_after_a_jax_iteration(world):
    """A whole JAX ``DreamerState`` whose optimizer states have all moved,
    into the port and back, exactly."""
    w = world
    jstate = w.get("jstate_after")
    if jstate is None:
        jstate, _ = w["jtr"].train_iteration(w["jstate"], w["jring"], jax.random.PRNGKey(50))
    j = jax.tree.map(np.asarray, jstate)
    got = bridge.export_dreamer_state(port_dreamer_state(Trainer(w["cfg"], device="cpu"),
                                                          jstate))
    close_trees(got["wm"]["params"], j.wm.params, 0.0, 0.0, "wm/params")
    adam = bridge._adam_of(j.wm.opt_state)
    assert got["wm"]["opt"]["count"] == int(adam.count) > 0
    close_trees(got["wm"]["opt"]["mu"], adam.mu, 0.0, 0.0, "wm/mu")
    close_trees(got["wm"]["opt"]["nu"], adam.nu, 0.0, 0.0, "wm/nu")
    for name in ("actor_params", "critic_params", "target_critic_params"):
        close_trees(got["ac"][name], getattr(j.ac, name), 0.0, 0.0, name)
    assert got["ac"]["actor_opt"]["count"] == int(bridge._adam_of(j.ac.actor_opt).count)
    assert got["ac"]["s_scale"] == float(j.ac.s_scale)
    assert got["step"] == int(j.step) > 0


def test_train_iteration_on_the_cpu(world):
    """``Trainer.train_iteration`` on its own generator: finite, unskipped
    updates, the world model moved, its kernel layouts rebuilt before the
    actor-critic half (the imagination reads the updated world model), the
    AC update computing no world-model gradient, and step + 1."""
    cfg = world["cfg"]
    trainer = Trainer(cfg, device="cpu", seed=1)
    state = trainer.init_state()
    ring = trainer.buffer.add_batch(trainer.buffer.init_state(),
                                    *map(t, ring_data(cfg, np.random.default_rng(6))))
    g = torch.Generator().manual_seed(0)
    nets = trainer.rssm.nets
    wm0 = [p.detach().clone() for p in nets.parameters()]
    layout0 = nets.imagine_weights()
    state, metrics = trainer.wm_step(state, ring, g)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert float(metrics["wm/update_skipped"]) == 0.0
    assert int(state.wm.opt.count) == cfg.train.wm_epochs
    assert all(not torch.equal(a, b) for a, b in zip(wm0, nets.parameters()))
    layout1 = nets.imagine_weights()
    assert layout1 is not layout0 and not torch.equal(layout1[0], layout0[0])
    wm1 = [p.detach().clone() for p in nets.parameters()]
    state, metrics = trainer.train_iteration(state, ring, g)
    assert int(state.step) == 1 and float(metrics["ac/update_skipped"]) == 0.0
    # The actor-critic loss has no path to a world-model parameter.
    batch = trainer.buffer.sample(ring, cfg.train.batch_size, g,
                                  t_out=cfg.train.sequence_length // 2)
    loss, _ = trainer.agent.ac_loss(state.ac, trainer.rssm, batch[0], batch[1],
                                    trainer.sample_ac_noise(cfg.train.batch_size, g))
    assert loss.requires_grad
    assert all(g is None for g in torch.autograd.grad(loss, list(nets.parameters()),
                                                      allow_unused=True))
    assert int(state.wm.opt.count) == 2 * cfg.train.wm_epochs
    assert all(not torch.equal(a, b) for a, b in zip(wm1, nets.parameters()))
