"""Parameters between the JAX package's flax trees and the port's modules.

A tree is a nested dict of numpy arrays, as the JAX package's params (or an
orbax restore of them) give after ``jax.tree.map(np.asarray, ...)``.

Layouts: a flax Dense ``kernel`` (in, out) is ``Dense.weight`` (out, in); a
flax Conv kernel HWIO is ``EncoderConv.weight`` OIHW; a flax ConvTranspose
kernel (kh, kw, in, out) is ``DecoderConv.weight`` (in, out, kh, kw) flipped
in both spatial axes; the GRU keeps flax's fused ``(in, 3H)`` / ``(H, 3H)``
kernels, gate order r, z, n.  After a load the kernels' own layouts (the
transposed GRU gate rows, the HWIO bf16 encoder weights) are made once, by
``WMNets.prepare_kernels``.

Covered: every ``wm`` subtree, the ``actor`` and ``critic`` trees, a whole
actor-critic training state (``load_ac_state``) and a whole ``DreamerState``
(``load_dreamer_state``), optimizer states included.  A key without a port
parameter raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
from dreamer_tpu_torch.nets.mlp import MLP, Dense, LayerNorm
from dreamer_tpu_torch.nets.wm_nets import WMNets

Tree = Dict[str, object]
# (flax path, parameter, flax leaf -> torch layout, torch -> flax layout)
_Entry = Tuple[Tuple[str, ...], nn.Parameter, object, object]

_same = lambda a: a  # noqa: E731
_t2 = lambda a: a.T  # noqa: E731  Dense (in, out) <-> (out, in)
_hwio_to_oihw = lambda a: a.transpose(3, 2, 0, 1)  # noqa: E731
_oihw_to_hwio = lambda a: a.transpose(2, 3, 1, 0)  # noqa: E731
_flax_to_deconv = lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)  # noqa: E731
_deconv_to_flax = lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1]  # noqa: E731


def _dense(prefix, d: Dense) -> Iterator[_Entry]:
    yield prefix + ("kernel",), d.weight, _t2, _t2
    yield prefix + ("bias",), d.bias, _same, _same


def _norm(prefix, n: LayerNorm) -> Iterator[_Entry]:
    yield prefix + ("scale",), n.scale, _same, _same
    yield prefix + ("bias",), n.bias, _same, _same


def _trunk(prefix, denses, norms) -> Iterator[_Entry]:
    for i, d in enumerate(denses):
        yield from _dense(prefix + (f"Dense_{i}",), d)
    for i, n in enumerate(norms):
        yield from _norm(prefix + (f"LayerNorm_{i}",), n)


def _wm_entries(nets: WMNets) -> Iterator[_Entry]:
    for i, conv in enumerate(nets.enc_convs):
        yield (f"enc_conv{i}", "kernel"), conv.weight, _hwio_to_oihw, _oihw_to_hwio
        yield (f"enc_conv{i}", "bias"), conv.bias, _same, _same
    head = nets.posterior_head
    yield from _trunk(("posterior_head",), head.denses, head.norms)
    g = nets.gru
    for name in ("kernel_i", "kernel_h", "bias_i", "bias_h"):
        yield ("gru", name), getattr(g, name), _same, _same
    for name in ("dyn_head", "reward_head", "cont_head"):
        yield from _mlp((name,), getattr(nets, name))
    yield from _dense(("upscaler_1",), nets.upscaler_1)
    yield from _norm(("upscaler_ln",), nets.upscaler_ln)
    yield from _dense(("upscaler_2",), nets.upscaler_2)
    for i, conv in enumerate(nets.dec_convs):
        yield (f"dec_conv{i}", "kernel"), conv.weight, _flax_to_deconv, _deconv_to_flax
        yield (f"dec_conv{i}", "bias"), conv.bias, _same, _same


def _mlp(prefix, m: MLP) -> Iterator[_Entry]:
    yield from _trunk(prefix, m.denses, m.norms)


def _actor_entries(actor: Actor) -> Iterator[_Entry]:
    yield from _trunk((), actor.denses, actor.norms)
    yield from _dense(("mu_head",), actor.mu_head)
    yield from _dense(("log_sig_head",), actor.log_sig_head)


def _critic_entries(critic: Critic) -> Iterator[_Entry]:
    yield from _mlp((), critic)


def _leaves(tree: Tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _load(entries, tree: Tree) -> None:
    entries = list(entries)
    known = {path for path, *_ in entries}
    for path, _ in _leaves(tree):
        if path not in known:
            raise KeyError(f"no port parameter for {'/'.join(path)}")
    with torch.no_grad():
        for path, param, to_torch, _ in entries:
            node = tree
            for k in path:
                if not isinstance(node, dict) or k not in node:
                    raise KeyError(f"missing parameter {'/'.join(path)}")
                node = node[k]
            value = to_torch(np.asarray(node, dtype=np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} does not fit "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def _export(entries) -> Tree:
    tree: Tree = {}
    for path, param, _, to_flax in entries:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(to_flax(param.detach().cpu().numpy()))
    return tree


def load_wm(nets: WMNets, tree: Tree) -> None:
    """Copy a flax ``wm`` tree into ``nets`` and make the kernel layouts."""
    _load(_wm_entries(nets), tree)
    nets.prepare_kernels()


def load_actor(actor: Actor, tree: Tree) -> None:
    _load(_actor_entries(actor), tree)


def export_wm(nets: WMNets) -> Tree:
    """The ``wm`` tree in the flax layout, float32 arrays."""
    return _export(_wm_entries(nets))


def export_actor(actor: Actor) -> Tree:
    return _export(_actor_entries(actor))


def load_critic(critic: Critic, tree: Tree) -> None:
    _load(_critic_entries(critic), tree)


def export_critic(critic: Critic) -> Tree:
    return _export(_critic_entries(critic))


# --------------------------------------------------------------------------- #
# A whole actor-critic training state
# --------------------------------------------------------------------------- #


def _adam_of(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax
    ``clip_by_global_norm`` -> ``adamw`` chain state, found by its fields so
    that the optax classes need not be imported."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_of(sub)
            if found is not None:
                return found
    return None


def _moment_entries(entries, module: nn.Module, moments) -> List[_Entry]:
    """``entries`` with each parameter replaced by its optimizer moment;
    ``moments`` are in ``module.parameters()`` order."""
    slot = {id(p): i for i, p in enumerate(module.parameters())}
    return [(path, moments[slot[id(p)]], a, b) for path, p, a, b in entries]


def _optimizers(state):
    """(port AdamState, module, its bridge entries) of both optimizers."""
    return ((state.actor_opt, state.actor, list(_actor_entries(state.actor))),
            (state.critic_opt, state.critic, list(_critic_entries(state.critic))))


def _load_adam(opt, module: nn.Module, entries, jax_opt) -> None:
    """An optax ``clip_by_global_norm`` -> ``adamw`` chain state into the
    port's ``AdamState`` of ``module``."""
    adam = _adam_of(jax_opt)
    if adam is None:
        raise KeyError("no (count, mu, nu) Adam state in the optimizer state")
    _load(_moment_entries(entries, module, opt.mu), adam.mu)
    _load(_moment_entries(entries, module, opt.nu), adam.nu)
    opt.count.fill_(int(np.asarray(adam.count)))


def _export_adam(opt, module: nn.Module, entries) -> Dict[str, object]:
    return {"count": int(opt.count),
            "mu": _export(_moment_entries(entries, module, opt.mu)),
            "nu": _export(_moment_entries(entries, module, opt.nu))}


def load_ac_state(state, jax_state) -> None:
    """Copy a JAX ``ACTrainState`` (``dreamer_tpu/train/state.py:20-26``),
    given with numpy leaves (``jax.tree.map(np.asarray, ...)``), into the
    port's ``train.state.ACTrainState``: the actor, critic and target-critic
    trees, the AdamW moments and step count of both optimizers, and
    ``s_scale``."""
    load_actor(state.actor, jax_state.actor_params)
    load_critic(state.critic, jax_state.critic_params)
    load_critic(state.target_critic, jax_state.target_critic_params)
    for (opt, module, entries), jax_opt in zip(_optimizers(state),
                                               (jax_state.actor_opt, jax_state.critic_opt)):
        _load_adam(opt, module, entries, jax_opt)
    state.s_scale.fill_(float(np.asarray(jax_state.s_scale)))


def export_ac_state(state) -> Dict[str, object]:
    """The port's ``ACTrainState`` as numpy in the JAX layout:
    ``{"actor_params", "critic_params", "target_critic_params": trees,
    "actor_opt", "critic_opt": {"count", "mu", "nu"}, "s_scale"}``."""
    opts = [_export_adam(opt, module, entries) for opt, module, entries in _optimizers(state)]
    return {"actor_params": export_actor(state.actor),
            "critic_params": export_critic(state.critic),
            "target_critic_params": export_critic(state.target_critic),
            "actor_opt": opts[0], "critic_opt": opts[1], "s_scale": float(state.s_scale)}


# --------------------------------------------------------------------------- #
# A whole training state
# --------------------------------------------------------------------------- #


def load_dreamer_state(state, jax_state) -> None:
    """Copy a JAX ``DreamerState`` (``dreamer_tpu/train/state.py:29-33``) with
    numpy leaves into the port's ``train.state.DreamerState``: the world
    model's parameters and AdamW state (and its kernel layouts made), the
    actor-critic state, and the step."""
    nets = state.wm.nets
    load_wm(nets, jax_state.wm.params)
    _load_adam(state.wm.opt, nets, list(_wm_entries(nets)), jax_state.wm.opt_state)
    load_ac_state(state.ac, jax_state.ac)
    state.step.fill_(int(np.asarray(jax_state.step)))


def export_dreamer_state(state) -> Dict[str, object]:
    """The port's ``DreamerState`` as numpy in the JAX layout: ``{"wm":
    {"params": tree, "opt": {"count", "mu", "nu"}}, "ac": export_ac_state,
    "step"}``."""
    nets = state.wm.nets
    return {"wm": {"params": export_wm(nets),
                   "opt": _export_adam(state.wm.opt, nets, list(_wm_entries(nets)))},
            "ac": export_ac_state(state.ac), "step": int(state.step)}
