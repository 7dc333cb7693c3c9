"""Shared set-up of the port's parity tests: the JAX package's nets at small
widths, their parameters as numpy trees, and the port's modules loaded with
the same values through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.rssm import RSSM as JaxRSSM
from dreamer_tpu.train.agent import AgentTrainer, make_actor_optimizer, make_critic_optimizer
from dreamer_tpu.train.state import ACTrainState as JaxACTrainState
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
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
