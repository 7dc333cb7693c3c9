"""Shared set-up of the port's parity tests: the JAX package's nets at small
widths, their parameters as numpy trees, and the port's modules loaded with
the same values through the bridge."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.rssm import RSSM as JaxRSSM
from dreamer_tpu.train.agent import AgentTrainer, make_actor_optimizer, make_critic_optimizer
from dreamer_tpu.train.state import ACTrainState as JaxACTrainState
from dreamer_tpu.train.state import DreamerState as JaxDreamerState
from dreamer_tpu.train.state import WMTrainState as JaxWMTrainState
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu.train.world_model import wm_update as jax_wm_update
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
from dreamer_tpu_torch.train import ACNoise, Trainer, wm_loss, wm_update
from dreamer_tpu_torch.train.state import ACTrainState, AdamState
from dreamer_tpu_torch.nets.wm_nets import WMNets

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def configs(path, compute_dtype):
    jcfg = JaxConfig.from_yaml(path)
    jcfg.runtime.compute_dtype = compute_dtype
    cfg = DreamerConfig.from_yaml(path)
    cfg.runtime.compute_dtype = compute_dtype
    return jcfg, cfg


def random_like(shapes, rng):
    """A tree of the JAX package's parameter shapes filled from numpy: kernels
    ~ N(0, 1/fan_in), biases ~ N(0, 0.1), LayerNorm scales ~ 1 + N(0, 0.1).
    (Every leaf random, so a wrong layout cannot hide behind zeros or ones.)"""
    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("kernel_i", "kernel_h", "bias_i", "bias_h"):
            bound = 1.0 / np.sqrt(shape[-1] // 3)
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_params(jcfg, seed=0):
    """(wm, actor) numpy trees with the JAX package's structure and shapes
    (traced, not run, from its own init) and random values."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    wm = jax.eval_shape(JaxRSSM(jcfg.wm, jcfg.env.action_dim).init_params, key)
    actor, _ = jax.eval_shape(
        lambda k: AgentTrainer(jcfg).init_params(k, jcfg.wm.hidden_dim, jcfg.wm.latent_dim), key)
    return random_like(wm, rng), random_like(actor, rng)


def port_nets(cfg, wm_tree, actor_tree):
    dtype = DTYPES[cfg.runtime.compute_dtype][1]
    nets = WMNets(cfg.wm, cfg.env.action_dim, dtype)
    bridge.load_wm(nets, wm_tree)
    a = cfg.agent
    actor = Actor(cfg.wm.hidden_dim + cfg.wm.latent_dim, cfg.env.action_dim,
                  a.actor_hidden_1, a.actor_hidden_2, a.min_std, dtype)
    bridge.load_actor(actor, actor_tree)
    return nets, actor


def t(a):
    """numpy/JAX array -> torch tensor (float32 stays float32)."""
    return torch.from_numpy(np.array(a))


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# The SMALL world model of tests/test_imagine_pallas.py (8 x 16 latents: the
# Pallas imagination needs rows * classes % 128 == 0), with an actor-critic
# and a schedule to match: B = 4, sequence length 8 (a 4-frame warm start),
# horizon 6.
SMALL = dict(hidden_dim=64, latent_rows=8, latent_classes=16, obs_size=(16, 16),
             encoder_filters_1=4, encoder_filters_2=8, encoder_hidden=32,
             decoder_filters_1=4, decoder_filters_2=8, decoder_hidden=32,
             dyn_hidden_1=24, dyn_hidden_2=24, rew_hidden_1=16, rew_hidden_2=16,
             cont_hidden_1=16, cont_hidden_2=16, reward_buckets=31)
SMALL_AGENT = dict(actor_hidden_1=24, actor_hidden_2=24, critic_hidden_1=24,
                   critic_hidden_2=24, critic_buckets=31, min_std=0.1)
SMALL_TRAIN = dict(batch_size=4, sequence_length=8, horizon=6, buffer_size=64, ac_epochs=2)


def small_configs():
    """(JAX config, port config) at the SMALL widths, float32."""
    jcfg, cfg = JaxConfig(), DreamerConfig()
    for c in (jcfg, cfg):
        c.wm = type(c.wm)(**SMALL)
        for k, v in SMALL_AGENT.items():
            setattr(c.agent, k, v)
        for k, v in SMALL_TRAIN.items():
            setattr(c.train, k, v)
        c.runtime.compute_dtype = "float32"
    return jcfg, cfg


def jax_ac_world(jcfg, seed=0):
    """The JAX actor-critic program at ``jcfg``: (wm tree, an ACTrainState
    with random actor, critic and a different target critic, fresh optax
    states and s_scale 1.3, the jitted ``ac_update(state, wm, batch, key)``).
    Every parameter is random (``random_like``)."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    A = jcfg.env.action_dim
    jrssm = JaxRSSM(jcfg.wm, A, dtype=jnp.float32, fused_scan_grads=True,
                    actor_min_std=jcfg.agent.min_std)
    wm = random_like(jax.eval_shape(jrssm.init_params, key), rng)
    agent = AgentTrainer(jcfg)
    actor_s, critic_s = jax.eval_shape(
        lambda k: agent.init_params(k, jcfg.wm.hidden_dim, jcfg.wm.latent_dim), key)
    actor, critic, target = (random_like(s, rng) for s in (actor_s, critic_s, critic_s))
    a_opt, c_opt = make_actor_optimizer(jcfg), make_critic_optimizer(jcfg)
    state = JaxACTrainState(actor, critic, target, a_opt.init(actor), c_opt.init(critic),
                            jnp.asarray(1.3, jnp.float32))

    def update(st, wm_params, batch, k, nu=None):
        return agent.ac_update(a_opt, c_opt, st, wm_params, jrssm, batch, k, nu=nu)

    return wm, state, jax.jit(update)


def port_ac_state(cfg, jstate):
    """A port ``ACTrainState`` at ``cfg``'s widths holding ``jstate``."""
    a = cfg.agent
    in_dim = cfg.wm.hidden_dim + cfg.wm.latent_dim
    actor = Actor(in_dim, cfg.env.action_dim, a.actor_hidden_1, a.actor_hidden_2, a.min_std)
    critic = Critic(in_dim, a.critic_buckets, a.critic_hidden_1, a.critic_hidden_2)
    target = Critic(in_dim, a.critic_buckets, a.critic_hidden_1,
                    a.critic_hidden_2).requires_grad_(False)
    state = ACTrainState(actor, critic, target, AdamState.zeros_like(actor),
                         AdamState.zeros_like(critic), torch.zeros(()))
    bridge.load_ac_state(state, jax.tree.map(np.asarray, jstate))
    return state


def jax_dreamer_world(jcfg, seed=0):
    """The JAX learner at ``jcfg``: (its jitted ``Trainer``, a
    ``DreamerState`` with every parameter random (``random_like``), fresh
    optax states, s_scale 1.3 and step 0)."""
    jtr = JaxTrainer(jcfg)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(seed))
    wm = random_like(shapes.wm.params, rng)
    actor, critic, target = (random_like(s, rng) for s in (
        shapes.ac.actor_params, shapes.ac.critic_params, shapes.ac.critic_params))
    ac = JaxACTrainState(actor, critic, target, jtr.actor_opt.init(actor),
                         jtr.critic_opt.init(critic), jnp.asarray(1.3, jnp.float32))
    state = JaxDreamerState(wm=JaxWMTrainState(wm, jtr.wm_opt.init(wm)), ac=ac,
                            step=jnp.zeros((), jnp.int32))
    return jtr, state


def port_dreamer_state(trainer, jstate):
    """``trainer.init_state()`` holding the JAX ``DreamerState`` ``jstate``."""
    state = trainer.init_state()
    bridge.load_dreamer_state(state, jax.tree.map(np.asarray, jstate))
    return state


def wm_gumbels(jcfg, key, batch_size):
    """The gumbels JAX's ``observe_sequence`` draws from ``key`` (one key per
    step of the horizon, ``rssm.py:236``), as the port's (H, B, rows,
    classes) tensor."""
    c = jcfg.wm
    keys = jax.random.split(key, jcfg.train.horizon)
    return t(jax.vmap(lambda k: jax.random.gumbel(k, (batch_size, c.latent_rows,
                                                      c.latent_classes)))(keys))


def close_trees(got, want, rtol, atol, where=""):
    """Two nested dicts of arrays with the same keys, leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            close_trees(got[k], want[k], rtol, atol, f"{where}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=where)


def same_wm_state(port_state, jwm, param_atol, moment_rtol, moment_atol):
    """The port's world-model parameters and AdamW state against a JAX
    ``WMTrainState``: the parameters to ``param_atol``, the moments to
    ``moment_rtol`` + ``moment_atol``, the step count exactly."""
    got = bridge.export_dreamer_state(port_state)["wm"]
    j = jax.tree.map(np.asarray, jwm)
    close_trees(got["params"], j.params, 0.0, param_atol, "wm/params")
    adam = bridge._adam_of(j.opt_state)
    assert got["opt"]["count"] == int(adam.count)
    close_trees(got["opt"]["mu"], adam.mu, moment_rtol, moment_atol, "wm/opt/mu")
    close_trees(got["opt"]["nu"], adam.nu, moment_rtol, moment_atol, "wm/opt/nu")


# The world-model update's parity set-up (tests/test_torch_world_model.py,
# tests/test_torch_wm_flags.py): B = 4 windows of the SMALL config's 8 steps.
WM_B, WM_A = 4, 3
# Every metric to 1e-4 rel + 1e-5 abs; the updated parameters to 1e-6 abs, a
# hundredth of the learning rate; the AdamW moments to 1e-5 rel + 1e-6 abs.
WM_METRIC_RTOL, WM_METRIC_ATOL = 1e-4, 1e-5
WM_PARAM_ATOL = 1e-6
WM_MOMENT_RTOL, WM_MOMENT_ATOL = 1e-5, 1e-6


def wm_world(flags=None, seed=0):
    """The JAX ``wm_update`` (jitted) and the port's ``Trainer`` on the CPU at
    the SMALL config with ``flags`` ({"section.name": value}) set on both,
    from the same random state (``jax_dreamer_world``)."""
    jcfg, cfg = small_configs()
    for k, v in (flags or {}).items():
        section, name = k.split(".")
        for c in (jcfg, cfg):
            setattr(getattr(c, section), name, v)
    jtr, jstate = jax_dreamer_world(jcfg, seed)
    trainer = Trainer(cfg, device="cpu")
    jupdate = jax.jit(lambda st, batch, key: jax_wm_update(jtr.rssm, jtr.wm_opt, st, batch, key,
                                                           jcfg))
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, trainer=trainer, jupdate=jupdate,
                pstate=port_dreamer_state(trainer, jstate))


def wm_batch(cfg, rng, conts=(), firsts=None, nan=False):
    """A replay batch of B windows: continue 0 at the (row, step) pairs
    ``conts``; the episode-start channel, 1 at the pairs ``firsts``, when
    given; a NaN reward when ``nan``."""
    B, T = WM_B, cfg.train.sequence_length
    obs = rng.integers(0, 256, (B, T, *cfg.wm.obs_size, 3), dtype=np.uint8)
    actions = rng.uniform(-1, 1, (B, T, WM_A)).astype(np.float32)
    rewards = (2.0 * rng.standard_normal((B, T))).astype(np.float32)
    if nan:
        rewards[2, 3] = np.nan
    c = np.ones((B, T), np.float32)
    for row, step in conts:
        c[row, step] = 0.0
    batch = [obs, actions, rewards, c]
    if firsts is not None:
        f = np.zeros((B, T), np.float32)
        for row, step in firsts:
            f[row, step] = 1.0
        batch.append(f)
    return batch


def wm_run_both(w, jwm_state, batch, key):
    """One update on each side from the same batch and noise; returns (the
    new JAX ``WMTrainState``, JAX's metrics, the port's metrics)."""
    jnew, jm = w["jupdate"](jwm_state, tuple(map(np.asarray, batch)), key)
    trainer = w["trainer"]
    before = gru_scan.launches
    _, pm = wm_update(trainer.rssm, trainer.wm_opt, w["pstate"].wm, [t(b) for b in batch],
                      wm_gumbels(w["jcfg"], key, WM_B), w["cfg"])
    assert gru_scan.launches == before  # the CPU takes the plain version
    return jnew, jax.tree.map(np.asarray, jm), pm


def same_wm_metrics(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(port[k]), np.asarray(ref[k]),
                                   rtol=WM_METRIC_RTOL, atol=WM_METRIC_ATOL, err_msg=k)


def check_wm_flag(flags, toggled, conts=(), firsts=None, seed=3):
    """One update under ``flags`` against JAX's, on ``wm_batch(conts,
    firsts)``; first showing that the flag ``toggled`` changes the port's
    metrics on that batch by more than the comparison's tolerance (so that the
    comparison exercises it)."""
    w = wm_world(flags, seed)
    cfg = w["cfg"]
    batch = wm_batch(cfg, np.random.default_rng(seed), conts, firsts)
    key = jax.random.PRNGKey(30)
    off = copy.deepcopy(cfg)
    section, name = toggled.split(".")
    setattr(getattr(off, section), name, getattr(getattr(DreamerConfig(), section), name))
    firsts_t = t(batch[4]) if len(batch) > 4 else None
    # The episode-start channel is in the batch iff the ring stores it.
    firsts_off = None if toggled == "env.next_step_autoreset" else firsts_t
    with torch.no_grad():
        on, off = (wm_loss(w["trainer"].rssm, *[t(b) for b in batch[:4]],
                           wm_gumbels(w["jcfg"], key, WM_B), c, firsts=f)[1]
                   for c, f in ((cfg, firsts_t), (off, firsts_off)))
    # Ignoring the flag would move a metric by more than twice its tolerance.
    moved = {k: abs(float(on[k] - off[k]))
             / (WM_METRIC_RTOL * abs(float(on[k])) + WM_METRIC_ATOL) for k in on}
    assert max(moved.values()) > 2, moved
    jwm, jm, pm = wm_run_both(w, w["jstate"].wm, batch, key)
    assert float(jm["wm/update_skipped"]) == 0.0
    same_wm_metrics(pm, jm)
    same_wm_state(w["pstate"], jwm, WM_PARAM_ATOL, WM_MOMENT_RTOL, WM_MOMENT_ATOL)


def ac_gumbels_and_normals(jcfg, key, batch_size):
    """The noise JAX's ``ac_loss`` draws from ``key`` (``agent.py:104-190``):
    k_warm, k_dream = split(key); the warm start's first sample from
    split(k_warm)[0], its steps from split(split(k_warm)[1], Tw - 1); the
    dream's eps and gumbels from the two halves of split(split(k_dream, H)[t])."""
    c, H, A = jcfg.wm, jcfg.train.horizon, jcfg.env.action_dim
    Tw = jcfg.train.sequence_length // 2
    lat = (batch_size, c.latent_rows, c.latent_classes)
    k_warm, k_dream = jax.random.split(key)
    key0, key_scan = jax.random.split(k_warm)
    warm = [jax.random.gumbel(key0, lat)] + [jax.random.gumbel(k, lat) for k in
                                            jax.random.split(key_scan, Tw - 1)]
    pairs = jax.vmap(jax.random.split)(jax.random.split(k_dream, H))
    eps = jax.vmap(lambda k: jax.random.normal(k, (batch_size, A)))(pairs[:, 0])
    gum = jax.vmap(lambda k: jax.random.gumbel(k, lat))(pairs[:, 1])
    return ACNoise(t(jnp.stack(warm)), t(eps), t(gum))


def iteration_draws(jtr, jring, key, jcfg):
    """Everything JAX's ``train_iteration(state, ring, key)`` draws, in the
    port's order of draws: ([the (env, start) indices of the WM epochs' then
    the AC epochs' samples], [the WM updates' gumbels], [the AC updates'
    ``ACNoise``]) (``step.py:131-188``)."""
    B = jcfg.train.batch_size
    k_wm, k_ac = jax.random.split(key)
    indices, wm_noise, ac_noise = [], [], []
    for keys, noise, draw in ((jax.random.split(k_wm, jcfg.train.wm_epochs), wm_noise,
                               wm_gumbels),
                              (jax.random.split(k_ac, jcfg.train.ac_epochs), ac_noise,
                               ac_gumbels_and_normals)):
        for k in keys:
            k_s, k_u = jax.random.split(k)
            env_idx, starts = jtr.buffer._draw_indices(jring, k_s, B)
            indices.append((t(env_idx).long(), t(starts).long()))
            noise.append(draw(jcfg, k_u, B))
    return indices, wm_noise, ac_noise
