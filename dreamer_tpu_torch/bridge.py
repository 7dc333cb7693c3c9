"""Parameters between the JAX package's flax trees and the port's modules.

A tree is a nested dict of numpy arrays, as the JAX package's params (or an
orbax restore of them) give after ``jax.tree.map(np.asarray, ...)``.

Layouts: a flax Dense ``kernel`` (in, out) is ``Dense.weight`` (out, in); a
flax Conv kernel HWIO is ``EncoderConv.weight`` OIHW; the GRU keeps flax's
fused ``(in, 3H)`` / ``(H, 3H)`` kernels, gate order r, z, n.  After a load the
kernels' own layouts (the transposed GRU gate rows, the HWIO bf16 encoder
weights) are made once, by ``WMNets.prepare_kernels``.

Covered: the ``wm`` subtrees of the serving path and the whole ``actor`` tree.
The ``wm`` subtrees named in ``DEFERRED_WM_KEYS`` come with the training slice
and are skipped; any other key raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from dreamer_tpu_torch.nets.actor_critic import Actor
from dreamer_tpu_torch.nets.mlp import Dense, LayerNorm
from dreamer_tpu_torch.nets.wm_nets import WMNets

DEFERRED_WM_KEYS = ("dyn_head", "reward_head", "cont_head", "upscaler_1", "upscaler_ln",
                    "upscaler_2", "dec_conv0", "dec_conv1", "dec_conv2", "dec_conv3")

Tree = Dict[str, object]
# (flax path, parameter, flax leaf -> torch layout, torch -> flax layout)
_Entry = Tuple[Tuple[str, ...], nn.Parameter, object, object]

_same = lambda a: a  # noqa: E731
_t2 = lambda a: a.T  # noqa: E731  Dense (in, out) <-> (out, in)
_hwio_to_oihw = lambda a: a.transpose(3, 2, 0, 1)  # noqa: E731
_oihw_to_hwio = lambda a: a.transpose(2, 3, 1, 0)  # noqa: E731


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


def _actor_entries(actor: Actor) -> Iterator[_Entry]:
    yield from _trunk((), actor.denses, actor.norms)
    yield from _dense(("mu_head",), actor.mu_head)
    yield from _dense(("log_sig_head",), actor.log_sig_head)


def _leaves(tree: Tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _load(entries, tree: Tree, skip=()) -> None:
    entries = list(entries)
    known = {path for path, *_ in entries}
    for path, _ in _leaves(tree):
        if path[0] not in skip and path not in known:
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
    _load(_wm_entries(nets), tree, skip=DEFERRED_WM_KEYS)
    nets.prepare_kernels()


def load_actor(actor: Actor, tree: Tree) -> None:
    _load(_actor_entries(actor), tree)


def export_wm(nets: WMNets) -> Tree:
    """The ported ``wm`` subtrees as a flax-layout tree of float32 arrays."""
    return _export(_wm_entries(nets))


def export_actor(actor: Actor) -> Tree:
    return _export(_actor_entries(actor))
