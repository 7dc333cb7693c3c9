"""The imagination as a differentiable function: the whole-rollout kernel
forward, the deferred-weight-gradient backward (the counterpart of the
imagination part of ``dreamer_tpu/ops/fused_scans.py:171-356``).

``imagine_scan`` is a ``torch.autograd.Function``:

- **Forward:** ``ops.imagine_cuda.imagine_rollout``, so the hand-written
  kernel on the card and its plain version on the CPU.
- **Residuals:** those of JAX: the parameters, h0, z0, eps, gum, h_seq and
  z_seq.
- **Backward:** the port of ``_imagine_bwd`` (``fused_scans.py:271-310``) and
  ``_actor_grads`` (``:313-329``).  A reverse-time loop recomputes each step
  (``imagine_cuda.imagine_step``, with the kernel's own rounding points, so
  that the recomputed probabilities are those the kernel sampled from) with a
  zero "tap" added at every Dense and LayerNorm output, and takes the carry
  and tap cotangents with ``torch.autograd.grad``.  Each weight gradient is
  then one (T*B)-flattened contraction of the layer's recorded inputs with
  its tap cotangents, and the LayerNorm scale/bias gradients come from the
  recomputed normalised inputs.  Only the gradients that
  ``ctx.needs_input_grad`` asks for are computed: the actor-critic update
  hands in the world model's parameters detached, so that is the actor's.

In JAX this backward is plain XLA, not a Pallas kernel; the recompute in
plain PyTorch here is therefore the port of that backward, not a plain
version standing in for a kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout, imagine_step

# Each tap: (the layer input it contracts with, the indices of its parameters
# in the flat list of ``scan_params``, kind).  Dense taps sit on the Dense
# output (compute dtype), LayerNorm taps on the normalised f32 output; a
# LayerNorm's recorded input is its normalised input.
_TAPS: Tuple[Tuple[str, str, Tuple[int, int], str], ...] = (
    ("a.Dense_0", "a.Dense_0", (0, 1), "dense"),
    ("a.LayerNorm_0", "a.LayerNorm_0", (2, 3), "ln"),
    ("a.Dense_1", "a.Dense_1", (4, 5), "dense"),
    ("a.LayerNorm_1", "a.LayerNorm_1", (6, 7), "ln"),
    ("a.mu_head", "a.head_in", (8, 9), "dense"),
    ("a.log_sig_head", "a.head_in", (10, 11), "dense"),
    ("g.i", "g.i", (12, 14), "gru"),
    ("g.h", "g.h", (13, 15), "gru"),
    ("d.Dense_0", "d.Dense_0", (16, 17), "dense"),
    ("d.LayerNorm_0", "d.LayerNorm_0", (18, 19), "ln"),
    ("d.Dense_1", "d.Dense_1", (20, 21), "dense"),
    ("d.LayerNorm_1", "d.LayerNorm_1", (22, 23), "ln"),
    ("d.Dense_2", "d.Dense_2", (24, 25), "dense"),
)


def scan_params(actor, nets) -> List[torch.Tensor]:
    """The 26 parameters the imagination reads, in the order of the kernel's
    operands: the actor's trunk and heads, the GRU cell (flax layout), the
    dynamics head."""
    a, g, d = actor, nets.gru, nets.dyn_head
    return [a.denses[0].weight, a.denses[0].bias, a.norms[0].scale, a.norms[0].bias,
            a.denses[1].weight, a.denses[1].bias, a.norms[1].scale, a.norms[1].bias,
            a.mu_head.weight, a.mu_head.bias, a.log_sig_head.weight, a.log_sig_head.bias,
            g.kernel_i, g.kernel_h, g.bias_i, g.bias_h,
            d.denses[0].weight, d.denses[0].bias, d.norms[0].scale, d.norms[0].bias,
            d.denses[1].weight, d.denses[1].bias, d.norms[1].scale, d.norms[1].bias,
            d.denses[2].weight, d.denses[2].bias]


class _ImagineScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, unimix, min_std, h0, z0, eps, gum, *params):
        out = imagine_rollout(h0, z0, eps, gum, weights, unimix, min_std)
        ctx.weights, ctx.unimix, ctx.min_std = weights, unimix, min_std
        ctx.save_for_backward(h0, z0, eps, gum, out[2], out[3], *params)
        return out

    @staticmethod
    def backward(ctx, d_hfin, d_zfin, d_hseq, d_zseq, d_aseq, d_museq, d_sigseq):
        h0, z0, eps, gum, h_seq, z_seq, *params = ctx.saved_tensors
        need_p = ctx.needs_input_grad[7:]
        weights = ctx.weights
        dt = weights[0].dtype
        taps_used = [tp for tp in _TAPS if any(need_p[i] for i in tp[2])]
        dtaps: Dict[str, List[torch.Tensor]] = {tp[0]: [] for tp in taps_used}
        acts: Dict[str, List[torch.Tensor]] = {tp[1]: [] for tp in taps_used}
        dh, dz = d_hfin.float(), d_zfin.float()
        for t in range(eps.shape[0] - 1, -1, -1):
            with torch.enable_grad():
                h = h_seq[t].detach().requires_grad_()
                z = z_seq[t].detach().requires_grad_()
                taps = {}
                for name, _, (iw, ib), kind in taps_used:
                    width = params[ib].shape[0]
                    taps[name] = torch.zeros(h.shape[0], width, device=h.device,
                                             dtype=torch.float32 if kind == "ln" else dt,
                                             requires_grad=True)
                rec: Dict[str, torch.Tensor] = {}
                s = imagine_step(weights, h, z, eps[t], gum[t], ctx.unimix, ctx.min_std,
                                 taps, rec)
                grads = torch.autograd.grad(
                    (s.h_next, s.z_next, s.action, s.mu, s.sigma),
                    (h, z, *taps.values()),
                    (dh, dz, d_aseq[t], d_museq[t], d_sigseq[t]), allow_unused=True)
            dh = _or_zeros(grads[0], h) + d_hseq[t]
            dz = _or_zeros(grads[1], z) + d_zseq[t]
            for (name, act, _, _), g in zip(taps_used, grads[2:]):
                dtaps[name].append(_or_zeros(g, taps[name]))
                if len(acts[act]) < len(dtaps[name]):
                    acts[act].append(rec[act].detach())

        out: List = [None] * len(params)
        for name, act, (iw, ib), kind in taps_used:
            g = torch.cat(dtaps[name]).float()          # (T*B, out)
            x = torch.cat(acts[act]).float()            # (T*B, in)
            if kind == "ln":
                if need_p[iw]:
                    out[iw] = (g * x).sum(0)
            elif need_p[iw]:
                out[iw] = x.t() @ g if kind == "gru" else g.t() @ x
            if need_p[ib]:
                out[ib] = g.sum(0)
        d_h0 = dh if ctx.needs_input_grad[3] else None
        d_z0 = dz if ctx.needs_input_grad[4] else None
        return (None, None, None, d_h0, d_z0, None, None, *out)


def _or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g


def imagine_scan(actor, nets, h0: torch.Tensor, z0: torch.Tensor, eps: torch.Tensor,
                 gum: torch.Tensor, unimix: float, min_std: float, wm_grad: bool = True):
    """The T-step imagination of ``actor`` in the world model ``nets``,
    differentiable in the actor's parameters, in the world model's unless
    ``wm_grad`` is False, and in (h0, z0).  eps (T, B, A) and gum (T, B,
    rows, classes) are the noise.
    Returns (h_fin, z_fin, h_seq, z_seq, a_seq, mu_seq, sig_seq), time-major,
    float32, with h_seq[t] the pre-step state."""
    weights = (*actor.imagine_weights(), *nets.imagine_weights())
    params = scan_params(actor, nets)
    if not wm_grad:
        params = params[:12] + [p.detach() for p in params[12:]]
    return _ImagineScan.apply(weights, unimix, min_std, h0.float().contiguous(),
                              z0.float().contiguous(), eps.float().contiguous(),
                              gum.float().contiguous(), *params)

