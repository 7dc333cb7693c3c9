"""The parameter bridge: exact round trips (the world model, decoder
included, actor, critic, and a whole actor-critic training state after a JAX
update; a whole ``DreamerState`` in tests/test_torch_train_iteration.py), the
keys it refuses, and the committed flagship export
(checkpoints/carracer_r3/agent_best) restored with the JAX package's own
checkpoint code: it round-trips whole, world model, actor, critic and target
critic, and its policy is served by both packages.

The flagship comparison runs in float32 (the export's own dtype) so that the
sampled latents match exactly; deterministic actions then agree to 1e-4 abs
(float32 sums over 4096-wide features in another order; measured ~1e-6)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (configs, f32, jax_ac_world, jax_params, port_ac_state, port_nets,
                           small_configs, t)
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.nets import Critic
from dreamer_tpu_torch.train import Policy, PolicyNoise, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED_WM_KEYS = {"enc_conv0", "enc_conv1", "enc_conv2", "enc_conv3", "posterior_head", "gru",
                  "dyn_head", "reward_head", "cont_head", "upscaler_1", "upscaler_ln",
                  "upscaler_2", "dec_conv0", "dec_conv1", "dec_conv2", "dec_conv3"}
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "car_racer.yaml")
AGENT_BEST = os.path.join(ROOT, "checkpoints", "carracer_r3", "agent_best")


@pytest.fixture(scope="module")
def trees():
    jcfg, cfg = configs(SMOKE, "float32")
    wm, actor = jax_params(jcfg, seed=2)
    return cfg, wm, actor


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_round_trip_is_exact(trees):
    cfg, wm, actor = trees
    nets, port_actor = port_nets(cfg, wm, actor)
    wm_back, actor_back = bridge.export_wm(nets), bridge.export_actor(port_actor)
    assert set(wm_back) == set(wm) == PORTED_WM_KEYS
    for expect, got in ((wm, wm_back), (actor, actor_back)):
        want = dict(_leaves(expect))
        have = dict(_leaves(got))
        assert set(want) == set(have)
        for path, v in want.items():
            assert have[path].dtype == np.float32 and have[path].shape == v.shape, path
            np.testing.assert_array_equal(have[path], v, err_msg="/".join(path))


def test_layouts(trees):
    cfg, wm, actor = trees
    nets, port_actor = port_nets(cfg, wm, actor)
    np.testing.assert_array_equal(f32(nets.enc_convs[1].weight),
                                  wm["enc_conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(f32(nets.posterior_head.denses[0].weight),
                                  wm["posterior_head"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(f32(port_actor.mu_head.weight), actor["mu_head"]["kernel"].T)
    # ConvTranspose: (kh, kw, in, out) flipped in both spatial axes -> (in, out, kh, kw).
    np.testing.assert_array_equal(f32(nets.dec_convs[2].weight),
                                  wm["dec_conv2"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
    wi_t, wh_t, bi, bh = nets.gru.kernel_weights()
    H = cfg.wm.hidden_dim
    np.testing.assert_array_equal(f32(wi_t[H:2 * H, :wm["gru"]["kernel_i"].shape[0]]),
                                  wm["gru"]["kernel_i"][:, H:2 * H].T)


def test_kernel_layouts_are_made_at_load(trees):
    cfg, wm, actor = trees
    nets, _ = port_nets(cfg, wm, actor)
    made = nets.gru.kernel_weights()
    assert nets.gru.kernel_weights() is made  # reused, not rebuilt per call
    wm2 = copy.deepcopy(wm)
    wm2["gru"]["kernel_i"] *= 2.0
    bridge.load_wm(nets, wm2)
    remade = nets.gru.kernel_weights()
    assert remade is not made
    np.testing.assert_allclose(f32(remade[0]), 2.0 * f32(made[0]))


def test_deferred_keys_are_skipped_and_unknown_keys_raise(trees):
    """No world-model key is deferred any more: every one has a port
    parameter, and an unknown or missing key raises."""
    cfg, wm, actor = trees
    assert set(wm) == PORTED_WM_KEYS
    nets, port_actor = port_nets(cfg, wm, actor)
    bad = copy.deepcopy(wm)
    bad["mystery_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="mystery_head"):
        bridge.load_wm(nets, bad)
    bad = copy.deepcopy(actor)
    bad["Dense_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="Dense_0/extra"):
        bridge.load_actor(port_actor, bad)
    bad = copy.deepcopy(wm)
    del bad["gru"]["bias_h"]
    with pytest.raises(KeyError, match="gru/bias_h"):
        bridge.load_wm(nets, bad)
    bad = copy.deepcopy(wm)
    bad["enc_conv0"]["kernel"] = bad["enc_conv0"]["kernel"][:, :, :, :2]
    with pytest.raises(ValueError, match="enc_conv0/kernel"):
        bridge.load_wm(nets, bad)


@pytest.fixture(scope="module")
def agent_best(tmp_path_factory):
    """The committed flagship export restored through the JAX package's own
    checkpoint code, as float32 numpy trees."""
    from dreamer_tpu.rssm import RSSM as JaxRSSM
    from dreamer_tpu.train.agent import AgentTrainer
    from dreamer_tpu.utils.checkpoint import CheckpointManager

    jcfg, cfg = configs(FLAGSHIP, "float32")
    jcfg.train.buffer_size = 8  # the Trainer's replay ring is not used here
    key = jax.random.PRNGKey(0)
    wm_shape = jax.eval_shape(JaxRSSM(jcfg.wm, jcfg.env.action_dim).init_params, key)
    actor_shape, critic_shape = jax.eval_shape(
        lambda k: AgentTrainer(jcfg).init_params(k, jcfg.wm.hidden_dim, jcfg.wm.latent_dim), key)
    zeros = lambda tree: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)  # noqa: E731
    target = {"wm": zeros(wm_shape), "actor": zeros(actor_shape),
              "critic": zeros(critic_shape), "target_critic": zeros(critic_shape)}
    tree = CheckpointManager(str(tmp_path_factory.mktemp("ckpt"))).restore_numpy(
        AGENT_BEST, target)
    return jcfg, cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_flagship_agent_best_round_trips_whole(agent_best):
    """Every tree of the export, the world model's decoder included, into the
    port's modules and back, exactly."""
    _, cfg, tree = agent_best
    trainer_state = Trainer(cfg, device="cpu").init_state()
    nets, ac = trainer_state.wm.nets, trainer_state.ac
    bridge.load_wm(nets, tree["wm"])
    bridge.load_actor(ac.actor, tree["actor"])
    bridge.load_critic(ac.critic, tree["critic"])
    bridge.load_critic(ac.target_critic, tree["target_critic"])
    back = {"wm": bridge.export_wm(nets), "actor": bridge.export_actor(ac.actor),
            "critic": bridge.export_critic(ac.critic),
            "target_critic": bridge.export_critic(ac.target_critic)}
    assert set(back["wm"]) == set(tree["wm"]) == PORTED_WM_KEYS
    for name, sub in tree.items():
        want, have = dict(_leaves(sub)), dict(_leaves(back[name]))
        assert have.keys() == want.keys(), name
        for path, v in want.items():
            np.testing.assert_array_equal(have[path], v, err_msg=f"{name}/{'/'.join(path)}")
    assert float(np.abs(tree["wm"]["dec_conv3"]["kernel"]).max()) > 0  # trained, not zeros


def test_flagship_agent_best_critics_and_heads_round_trip(agent_best):
    _, cfg, tree = agent_best
    a = cfg.agent
    in_dim = cfg.wm.hidden_dim + cfg.wm.latent_dim
    for name in ("critic", "target_critic"):
        critic = Critic(in_dim, a.critic_buckets, a.critic_hidden_1, a.critic_hidden_2)
        bridge.load_critic(critic, tree[name])
        assert dict(_leaves(bridge.export_critic(critic))).keys() == dict(
            _leaves(tree[name])).keys()
        for path, v in _leaves(bridge.export_critic(critic)):
            np.testing.assert_array_equal(v, dict(_leaves(tree[name]))[path])
    assert tree["critic"]["Dense_2"]["kernel"].shape == (200, 255)
    policy = Policy(cfg, device="cpu")
    bridge.load_wm(policy.rssm.nets, tree["wm"])
    back = bridge.export_wm(policy.rssm.nets)
    for head in ("dyn_head", "reward_head", "cont_head"):
        want = dict(_leaves(tree["wm"][head]))
        assert dict(_leaves(back[head])).keys() == want.keys()
        for path, v in _leaves(back[head]):
            np.testing.assert_array_equal(v, want[path], err_msg=f"{head}/{path}")
    assert float(np.abs(tree["wm"]["dyn_head"]["Dense_2"]["kernel"]).max()) > 0


def test_ac_state_round_trips_after_a_jax_update():
    """A whole JAX ACTrainState, after one update (so that both AdamW states
    and the return scale have moved), carried into the port and back."""
    jcfg, cfg = small_configs()
    wm, jstate, jupdate = jax_ac_world(jcfg, seed=7)
    rng = np.random.default_rng(7)
    B, Tw = jcfg.train.batch_size, jcfg.train.sequence_length // 2
    batch = (jnp.asarray(rng.integers(0, 256, (B, Tw, *jcfg.wm.obs_size, 3), dtype=np.uint8)),
             jnp.asarray(rng.uniform(-1, 1, (B, Tw, 3)).astype(np.float32)))
    jstate, metrics = jupdate(jstate, wm, batch, jax.random.PRNGKey(1))
    assert float(metrics["ac/update_skipped"]) == 0.0
    j = jax.tree.map(np.asarray, jstate)
    got = bridge.export_ac_state(port_ac_state(cfg, jstate))
    for name in ("actor_params", "critic_params", "target_critic_params"):
        want = dict(_leaves(getattr(j, name)))
        have = dict(_leaves(got[name]))
        assert have.keys() == want.keys()
        for path, v in want.items():
            np.testing.assert_array_equal(have[path], v, err_msg=f"{name}/{path}")
    for name in ("actor_opt", "critic_opt"):
        adam = bridge._adam_of(getattr(j, name))
        assert got[name]["count"] == int(adam.count) == 1
        for moment in ("mu", "nu"):
            want = dict(_leaves(getattr(adam, moment)))
            have = dict(_leaves(got[name][moment]))
            assert have.keys() == want.keys()
            assert any(v.any() for v in want.values())
            for path, v in want.items():
                np.testing.assert_array_equal(have[path], v, err_msg=f"{name}/{moment}/{path}")
    assert got["s_scale"] == float(j.s_scale) != 1.3


def test_flagship_agent_best_serves_the_same_actions(agent_best):
    """Bridge the committed flagship export and serve a few frames with both
    packages."""
    from dreamer_tpu.train.step import Trainer

    jcfg, cfg, tree = agent_best
    wm, actor = tree["wm"], tree["actor"]
    assert wm["gru"]["kernel_i"].shape == (32 * 32 + 3, 3 * 600)
    assert float(np.abs(actor["mu_head"]["kernel"]).max()) > 0  # trained, not the zero init

    policy = Policy(cfg, device="cpu")
    bridge.load_wm(policy.rssm.nets, wm)
    bridge.load_actor(policy.actor, actor)
    trainer = Trainer(jcfg, jit=True)

    n, rng = 2, np.random.default_rng(0)
    obs = rng.integers(0, 256, (4, n, 64, 64, 3), dtype=np.uint8)
    shape = (n, jcfg.wm.latent_rows, jcfg.wm.latent_classes)
    key = jax.random.PRNGKey(5)
    h_j, z_j = trainer.policy_reset(wm, jnp.asarray(obs[0]), key)
    h_p, z_p = policy.policy_reset(t(obs[0]), t(jax.random.gumbel(key, shape)))
    a_j, a_p = jnp.zeros((n, 3)), torch.zeros(n, 3)
    for step in range(1, 4):
        key = jax.random.fold_in(key, step)
        done = np.array([step == 2, False])
        h_j, z_j, a_j = trainer.policy_act_observe(wm, actor, h_j, z_j, a_j,
                                                   jnp.asarray(obs[step]), jnp.asarray(done),
                                                   key, deterministic=True)
        k_obs, k_reset, _ = jax.random.split(key, 3)
        noise = PolicyNoise(t(jax.random.gumbel(k_obs, shape)),
                            t(jax.random.gumbel(k_reset, shape)), None)
        h_p, z_p, a_p = policy.policy_act_observe(h_p, z_p, a_p, t(obs[step]), t(done),
                                                  noise, deterministic=True)
        np.testing.assert_array_equal(np.rint(f32(z_p)), np.rint(f32(z_j)))
        np.testing.assert_allclose(f32(h_p), f32(h_j), atol=1e-4)
        np.testing.assert_allclose(f32(a_p), f32(a_j), atol=1e-4)
