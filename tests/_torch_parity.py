"""Shared set-up of the port's parity tests: the JAX package's nets at small
widths, their parameters as numpy trees, and the port's modules loaded with
the same values through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.rssm import RSSM as JaxRSSM
from dreamer_tpu.train.agent import AgentTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.actor_critic import Actor
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
