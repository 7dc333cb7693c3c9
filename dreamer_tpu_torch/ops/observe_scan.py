"""The posterior (observe) scan as a differentiable function: the per-step
forward through the GRU-cell kernel, the deferred-weight-gradient backward
with the GRU residuals from one launch of the whole-scan GRU kernel (the
counterpart of ``dreamer_tpu/ops/fused_scans.py:364-572``).

``observe_scan`` and ``observe_scan_reset`` run one ``torch.autograd.Function``:

- **Forward:** T posterior steps, h' = GRU([z ‖ a], h) through
  ``nets.gru`` (``ops.gru_cuda.gru_cell``: the kernel on the card, its plain
  version on the CPU), then the posterior MLP on [feat ‖ h'], unimix and the
  gumbel-argmax straight-through sample ``onehot + p - sg(p)``.  The reset
  variant first zeroes h, z and the incoming action where ``is_first`` is 1
  (``fused_scans.py:489-500``).
- **Residuals:** those of JAX: the parameters, h0, z0, feats, a_in, gum,
  is_first, h_seq and z_seq.
- **Backward:** the port of ``_observe_bwd`` / ``_observe_reset_bwd``.  The
  pre-step states (h_prev, z_prev; masked in the reset variant) of all T
  steps go through ``ops.gru_scan_cuda.gru_scan`` in ONE launch at T = 1 over
  their T * B rows, which gives every step's GRU residuals r, z, n and hn in
  place of a recompute per reverse step.  A reverse-time loop then takes, per
  step, the posterior MLP's cotangents by ``torch.autograd.grad`` of its
  recompute (with a zero "tap" added at every Dense and LayerNorm output) and
  the GRU's gate cotangents in closed form from the residuals, as
  ``gru_pallas._bwd`` (``:136-164``) does.  Every weight gradient is then one
  (T*B)-flattened contraction of a layer's recorded inputs with its tap
  cotangents, as ``fused_scans.py:466-477``; the features' cotangents go back
  to the encoder.

In JAX this backward is plain XLA; only the GRU residuals come from a kernel
here, so the plain PyTorch around it is the port of that backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from dreamer_tpu_torch.core.dists import sample_onehot_ste, unimix_probs
from dreamer_tpu_torch.ops import gru_cuda, gru_scan_cuda
from dreamer_tpu_torch.ops.imagine_cuda import NEAR_TIE


def observe_params(nets) -> List[torch.Tensor]:
    """The parameters the posterior scan reads: the GRU cell (flax layout:
    kernel_i, kernel_h, bias_i, bias_h), then the posterior head's layers in
    flax's order (Dense_0, LayerNorm_0, ..., the last Dense)."""
    g, head = nets.gru, nets.posterior_head
    out = [g.kernel_i, g.kernel_h, g.bias_i, g.bias_h]
    for i, dense in enumerate(head.denses):
        out += [dense.weight, dense.bias]
        if i < len(head.norms):
            out += [head.norms[i].scale, head.norms[i].bias]
    return out


def _posterior(nets, feat, h, taps: Dict[str, torch.Tensor], acts: Dict[str, torch.Tensor]):
    """``nets.posterior_logits`` with its numerics (``nets/mlp.py``), a tap
    added at every Dense and LayerNorm output, and each Dense's input and
    each LayerNorm's normalised input recorded in ``acts``."""
    head = nets.posterior_head
    x = torch.cat([feat.to(nets.dtype), h.to(nets.dtype)], dim=-1)
    for i, (dense, norm) in enumerate(zip(head.denses, head.norms)):
        acts[f"Dense_{i}"] = x
        pre = dense(x) + taps[f"Dense_{i}"]
        pf = pre.float()
        mean = pf.mean(-1, keepdim=True)
        var = torch.clamp((pf * pf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        rs = torch.rsqrt(var + norm.eps)
        acts[f"LayerNorm_{i}"] = (pf - mean) * rs
        y = (pf - mean) * (rs * norm.scale) + norm.bias + taps[f"LayerNorm_{i}"]
        x = torch.nn.functional.silu(y.to(norm.dtype))
    last = len(head.norms)
    acts[f"Dense_{last}"] = x
    logits = head.denses[last](x) + taps[f"Dense_{last}"]
    c = nets.cfg
    return logits.reshape(logits.shape[:-1] + (c.latent_rows, c.latent_classes))


def _or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g


class _ObserveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nets, unimix, h0, z0, feats, a_in, gum, is_first, *params):
        T, B = feats.shape[:2]
        h, z = h0, z0
        h_seq, z_seq, logit_seq = [], [], []
        for t in range(T):
            a = a_in[t]
            if is_first is not None:
                keep = (1.0 - is_first[t])[:, None]
                h, z, a = h * keep, z * keep, a * keep
            h = nets.gru_step(z, a, h).float()
            logits = nets.posterior_logits(feats[t], h)
            z = sample_onehot_ste(unimix_probs(logits, unimix), gum[t]).reshape(B, -1)
            h_seq.append(h)
            z_seq.append(z)
            logit_seq.append(logits)
        h_seq, z_seq = torch.stack(h_seq), torch.stack(z_seq)
        ctx.nets, ctx.unimix = nets, unimix
        ctx.has_reset = is_first is not None
        mask = is_first if is_first is not None else torch.zeros(())
        ctx.save_for_backward(h0, z0, feats, a_in, gum, mask, h_seq, z_seq)
        return h_seq, z_seq, torch.stack(logit_seq)

    @staticmethod
    def backward(ctx, d_hseq, d_zseq, d_logitseq):
        h0, z0, feats, a_in, gum, is_first, h_seq, z_seq = ctx.saved_tensors
        nets = ctx.nets
        dt = nets.dtype
        T, B = feats.shape[:2]
        H, Z = h0.shape[1], z0.shape[1]
        wi_t, wh_t, bi, bh = nets.gru.kernel_weights()

        # The pre-step states, masked as the forward masked them, and every
        # step's GRU residuals from one T = 1 launch over all T * B rows.
        h_prev = torch.cat([h0[None], h_seq[:-1]])
        z_prev = torch.cat([z0[None], z_seq[:-1]])
        a_prev = a_in
        keep = None
        if ctx.has_reset:
            keep = (1.0 - is_first)[..., None]
            h_prev, z_prev, a_prev = h_prev * keep, z_prev * keep, a_prev * keep
        xg = torch.cat([z_prev, a_prev], dim=-1).to(dt).reshape(1, T * B, -1).contiguous()
        hg = h_prev.to(dt).reshape(T * B, H).float().contiguous()
        _, r, zg, n, hn = (v.reshape(T, B, H)
                           for v in gru_scan_cuda.gru_scan(xg, hg, wi_t, wh_t, bi, bh))
        hf = hg.reshape(T, B, H)
        wi = wi_t[:, :xg.shape[-1]].float()
        wh = wh_t[:, :H].float()

        head = nets.posterior_head
        widths = {f"Dense_{i}": d.bias.shape[0] for i, d in enumerate(head.denses)}
        widths.update({f"LayerNorm_{i}": ln.bias.shape[0] for i, ln in enumerate(head.norms)})
        dtaps: Dict[str, List[torch.Tensor]] = {k: [] for k in widths}
        acts: Dict[str, List[torch.Tensor]] = {k: [] for k in widths}
        d_gi, d_gh, d_feats = [], [], []
        dh = torch.zeros_like(h0)
        dz = torch.zeros_like(z0)
        for t in range(T - 1, -1, -1):
            g_h = dh + d_hseq[t]
            g_z = dz + d_zseq[t]
            with torch.enable_grad():
                ht = h_seq[t].detach().requires_grad_()
                ft = feats[t].detach().requires_grad_()
                taps = {k: torch.zeros(B, w, device=ht.device, requires_grad=True,
                                       dtype=torch.float32 if k.startswith("L") else dt)
                        for k, w in widths.items()}
                rec: Dict[str, torch.Tensor] = {}
                logits = _posterior(nets, ft, ht, taps, rec)
                probs = unimix_probs(logits, ctx.unimix)
                grads = torch.autograd.grad(
                    (logits, probs), (ht, ft, *taps.values()),
                    (d_logitseq[t], g_z.reshape(probs.shape)), allow_unused=True)
            g_h = g_h + _or_zeros(grads[0], ht)
            d_feats.append(_or_zeros(grads[1], ft))
            for k, g in zip(widths, grads[2:]):
                dtaps[k].append(_or_zeros(g, taps[k]))
                acts[k].append(rec[k].detach())

            # The GRU step's gate cotangents from its residuals (gru_pallas._bwd).
            dzg = g_h * (hf[t] - n[t]) * zg[t] * (1.0 - zg[t])
            dn = g_h * (1.0 - zg[t]) * (1.0 - n[t] * n[t])
            dr = dn * hn[t] * r[t] * (1.0 - r[t])
            gi = torch.cat([dr, dzg, dn], dim=-1)
            gh = torch.cat([dr, dzg, dn * r[t]], dim=-1)
            d_gi.append(gi)
            d_gh.append(gh)
            dh = g_h * zg[t] + gh @ wh
            dz = (gi @ wi)[:, :Z]
            if keep is not None:
                dh, dz = dh * keep[t], dz * keep[t]

        # Deferred weight gradients: one (T*B)-flattened contraction each (the
        # per-step lists, filled in reverse time, are all in the same order).
        def flat(seq):
            return torch.cat(seq).float()

        gi_all, gh_all = flat(d_gi[::-1]), flat(d_gh[::-1])
        out = [xg[0].float().t() @ gi_all, hg.t() @ gh_all, gi_all.sum(0), gh_all.sum(0)]
        for i in range(len(head.denses)):
            g, x = flat(dtaps[f"Dense_{i}"]), flat(acts[f"Dense_{i}"])
            out += [g.t() @ x, g.sum(0)]
            if i < len(head.norms):
                g, x = flat(dtaps[f"LayerNorm_{i}"]), flat(acts[f"LayerNorm_{i}"])
                out += [(g * x).sum(0), g.sum(0)]
        d_feats = torch.stack(d_feats[::-1]).to(feats.dtype)
        return (None, None, dh, dz, d_feats, None, None, None, *out)


def _apply(nets, h0, z0, feats, a_in, gum, is_first: Optional[torch.Tensor]):
    return _ObserveScan.apply(nets, nets.cfg.unimix, h0.float(), z0.float(), feats,
                              a_in.float(), gum.float(), is_first, *observe_params(nets))


def observe_scan(nets, h0, z0, feats, a_in, gum):
    """T posterior steps of the world model ``nets`` from (h0, z0),
    differentiable in the GRU and posterior-head parameters, (h0, z0) and the
    features.  feats (T, B, F) encoder features, a_in (T, B, A) the previous
    actions, gum (T, B, rows, classes) the gumbels.  Returns (h_seq, z_seq,
    logits_seq) time-major, h_seq[t] the post-step state (float32), logits in
    the compute dtype."""
    return _apply(nets, h0, z0, feats, a_in, gum, None)


def observe_scan_reset(nets, h0, z0, feats, a_in, gum, is_first):
    """``observe_scan`` with h, z and the incoming action zeroed before the
    steps where ``is_first`` (T, B) is 1."""
    return _apply(nets, h0, z0, feats, a_in, gum, is_first.float())


@torch.no_grad()
def hold_observe(nets, feats, a_in, gum, h_seq, z_seq) -> Dict[str, object]:
    """Hold the kernels of one posterior scan, run forward from the zero
    state without resets, at its own operands: feats (T, B, F), a_in (T, B,
    A), gum (T, B, rows, classes) its inputs, h_seq and z_seq (T, B, .) its
    outputs.  The T * B pre-step states are rebuilt from the outputs, and:

    - the GRU cell is launched again at T = 1 over all of them; it runs the
      same code on the same numbers, so it must reproduce the forward's h_seq
      bit for bit (``carry_mismatches`` counts the (step, row) pairs that
      differ), and it is held to ``gru_cell_plain`` within
      ``gru_cuda.tolerance``;
    - the forward's sampled categories must be those of the plain cell's
      state through the posterior head, except in latent rows whose plain
      top-two scores lie within ``imagine_cuda.NEAR_TIE`` (``near_ties``,
      ``flips``);
    - the whole-scan GRU at the backward's form (T = 1 over the T * B
      states) is held to ``gru_scan_plain`` within ``gru_scan_cuda.tolerance``;
      ``scan_vs_forward_mismatches`` counts the (step, row) pairs whose
      state, rounded to the compute dtype, is not the forward's (chip_smoke
      gates it at 0 on the card, where the two kernels share one summation
      order; the CPU's plain versions need not).

    Returns the numbers; ``failures`` lists what broke."""
    T, B = feats.shape[:2]
    H = h_seq.shape[-1]
    c = nets.cfg
    ops = nets.gru.kernel_weights()
    dt = ops[0].dtype
    h_prev = torch.cat([torch.zeros_like(h_seq[:1]), h_seq[:-1]]).reshape(T * B, H)
    z_prev = torch.cat([torch.zeros_like(z_seq[:1]), z_seq[:-1]]).reshape(T * B, -1)
    xg = torch.cat([z_prev, a_in.reshape(T * B, -1)], dim=-1).to(dt).contiguous()
    hg = h_prev.to(dt).contiguous()
    stats: Dict[str, object] = {"rows": T * B}
    failures = []

    cell = gru_cuda.gru_cell(xg, hg, *ops)
    plain = gru_cuda.gru_cell_plain(xg, hg, *ops)
    diff = (cell.float() - plain.float()).abs()
    stats["max_abs_err_cell"] = float(diff.max())
    if bool((diff > gru_cuda.tolerance(plain)).any()):
        failures.append(f"GRU cell: max |kernel - plain| {float(diff.max()):.3e} over the "
                        "tolerance")
    differ = (cell.float() != h_seq.reshape(T * B, H)).any(-1)
    stats["carry_mismatches"] = float(differ.sum())
    if stats["carry_mismatches"]:
        failures.append(f"{int(stats['carry_mismatches'])} (step, row) pairs of the forward "
                        "differ from the GRU cell relaunched on their own pre-step states")

    logits = nets.posterior_logits(feats.reshape(T * B, -1), plain.float()).float()
    scores = torch.log(unimix_probs(logits, c.unimix)) + gum.reshape(logits.shape)
    top2 = scores.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    cats = z_seq.reshape(T * B, c.latent_rows, c.latent_classes).argmax(-1)
    flipped = cats != scores.argmax(-1)
    stats["latent_rows"] = float(near.numel())
    stats["near_ties"] = float(near.sum())
    stats["flips"] = float((flipped & near).sum())
    stats["flips_not_near_tie"] = float((flipped & ~near).sum())
    if stats["flips_not_near_tie"]:
        failures.append(f"{int(stats['flips_not_near_tie'])} latent rows sampled another "
                        "category than the plain cell's state outside a near tie")

    scan = gru_scan_cuda.gru_scan(xg[None], hg.float(), *ops)
    scan_stats = gru_scan_cuda.compare(scan, gru_scan_cuda.gru_scan_plain(xg[None], hg.float(),
                                                                          *ops))
    failures += [f"scan {f}" for f in scan_stats.pop("failures")]
    stats.update({f"scan_{k}": v for k, v in scan_stats.items()})
    stats["scan_vs_forward_mismatches"] = float(
        (scan[0][0].to(dt).float() != h_seq.reshape(T * B, H)).any(-1).sum())
    stats["failures"] = failures
    return stats
