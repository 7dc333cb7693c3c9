"""The port's posterior scan (``ops.observe_scan``: ``observe_scan`` and
``observe_scan_reset``; ``RSSM.observe_sequence``) against the JAX package's,
at the SMALL config of tests/test_imagine_pallas.py (GRU 64, 8x16 latents),
B = 4, T = 6, float32, from the same parameters, inputs and gumbels made
with numpy:

- the scans against JAX's deferred-weight-gradient ``observe_scan`` /
  ``observe_scan_reset`` (``fused_scans.py:364-572``): forward outputs, with
  equal sampled categories, to 1e-5 abs/rel, and every gradient of a
  weighted sum of the outputs (GRU and posterior-head parameters, h0, z0,
  the features) to 1e-4 rel + 1e-5 abs (the backward sums over T*B in
  another order through six recurrent steps);
- the whole ``observe_sequence``, encoder included, against ``jax.grad`` of
  the JAX module scan (``fused_scan_grads`` off), as
  tests/test_fused_scans.py holds JAX's own fused scan: the same tolerances,
  every parameter the scan reads (the encoder's gradients come from the
  encoder's recompute backward, ``conv_cuda.encode``).

The card runs the same backward with the residuals from the whole-scan GRU
kernel; tests/test_torch_gru_scan.py holds its plain version against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL, close_trees, random_like, t
from dreamer_tpu.config import WorldModelConfig as JaxWMConfig
from dreamer_tpu.ops.fused_scans import _ObserveCfg
from dreamer_tpu.ops.fused_scans import observe_scan as jax_observe_scan
from dreamer_tpu.ops.fused_scans import observe_scan_reset as jax_observe_scan_reset
from dreamer_tpu.rssm import RSSM as JaxRSSM
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import WorldModelConfig
from dreamer_tpu_torch.nets import gru as gru_module
from dreamer_tpu_torch.ops import gru_cuda
from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
from dreamer_tpu_torch.ops.observe_scan import (hold_observe, observe_params, observe_scan,
                                                observe_scan_reset)
from dreamer_tpu_torch.rssm import RSSM

ROWS, CLASSES, B, T, A = 8, 16, 4, 6, 3
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    jwm = JaxWMConfig(**SMALL)
    wm = random_like(jax.eval_shape(JaxRSSM(jwm, A).init_params, jax.random.PRNGKey(0)), rng)
    rssm = RSSM(WorldModelConfig(**SMALL), A)
    bridge.load_wm(rssm.nets, wm)
    return jwm, wm, rssm


def _flags():
    f = np.zeros((T, B), np.float32)
    f[3, 0] = f[1, 2] = f[4, 2] = 1.0
    return f


def _loss(h, z, logits, w_h):
    """Every output, with distinct nonlinear weights (as tests/test_fused_scans.py)."""
    lib = torch if isinstance(h, torch.Tensor) else jnp
    return lib.sum(h ** 2 * w_h) + 2.0 * lib.sum(z ** 3) + lib.sum(lib.sin(logits))


def _port_param_grads(grads, nets):
    """The gradients of ``observe_params(nets)`` as JAX's {gru, post} trees."""
    g = dict(zip(("kernel_i", "kernel_h", "bias_i", "bias_h"), (x.numpy() for x in grads[:4])))
    post, rest = {}, list(grads[4:])
    n_hidden = len(nets.posterior_head.norms)
    for i in range(n_hidden + 1):
        w, b = rest.pop(0), rest.pop(0)
        post[f"Dense_{i}"] = {"kernel": w.numpy().T, "bias": b.numpy()}
        if i < n_hidden:
            s, lb = rest.pop(0), rest.pop(0)
            post[f"LayerNorm_{i}"] = {"scale": s.numpy(), "bias": lb.numpy()}
    return {"gru": g, "post": post}


@pytest.mark.parametrize("reset", [False, True])
def test_observe_scan_matches_jax(world, reset):
    jwm, wm, rssm = world
    nets = rssm.nets
    rng = np.random.default_rng(1)
    h0 = np.tanh(rng.standard_normal((B, jwm.hidden_dim))).astype(np.float32)
    z0 = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (B, ROWS))].reshape(B, -1)
    feats = rng.standard_normal((T, B, nets.feat_dim)).astype(np.float32)
    a_in = rng.uniform(-1, 1, (T, B, A)).astype(np.float32)
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (T, B, ROWS, CLASSES))
    gum = (-np.log(-np.log(u))).astype(np.float32)
    w_h = rng.uniform(0.5, 1.5, (T, B, jwm.hidden_dim)).astype(np.float32)
    flags = _flags()

    ocfg = _ObserveCfg(unimix=jwm.unimix, latent_dim=jwm.latent_dim, rows=ROWS,
                       classes=CLASSES, dtype=jnp.float32, unroll=1)
    sub = {"gru": wm["gru"], "post": wm["posterior_head"]}

    def jax_loss(sub, h0, z0, feats):
        extra = (jnp.asarray(flags),) if reset else ()
        fn = jax_observe_scan_reset if reset else jax_observe_scan
        out = fn(ocfg, sub, h0, z0, feats, jnp.asarray(a_in), jnp.asarray(gum), *extra)
        return _loss(*out, jnp.asarray(w_h)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                   has_aux=True))(sub, h0, z0, feats)

    h0_t, z0_t, f_t = (t(v).requires_grad_() for v in (h0, z0, feats))
    params = observe_params(nets)
    before = gru_scan.launches
    if reset:
        out = observe_scan_reset(nets, h0_t, z0_t, f_t, t(a_in), t(gum), t(flags))
    else:
        out = observe_scan(nets, h0_t, z0_t, f_t, t(a_in), t(gum))
    grads = torch.autograd.grad(_loss(*out, t(w_h)), [h0_t, z0_t, f_t, *params])
    assert gru_scan.launches == before  # the CPU takes the plain version

    def cats(z):
        return np.asarray(z).reshape(T, B, ROWS, CLASSES).argmax(-1)

    np.testing.assert_array_equal(cats(out[1].detach()), cats(jout[1]))
    for name, o, r in zip(("h_seq", "z_seq", "logits"), out, jout):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for name, g, r in zip(("h0", "z0", "feats"), grads[:3], jgrads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    close_trees(_port_param_grads(grads[3:], nets), jgrads[0], GRAD_RTOL, GRAD_ATOL)


def _grad_tree(nets):
    """Each parameter's ``.grad`` (zero where none) as a flax-layout tree."""
    entries = [(path, p.grad if p.grad is not None else torch.zeros_like(p), a, b)
               for path, p, a, b in bridge._wm_entries(nets)]
    return bridge._export(entries)


@pytest.mark.parametrize("reset", [False, True])
def test_observe_sequence_matches_jax_autodiff(world, reset):
    jwm, wm, rssm = world
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 256, (B, T, *jwm.obs_size, 3), dtype=np.uint8)
    actions = rng.uniform(-1, 1, (B, T, A)).astype(np.float32)
    w_h = rng.uniform(0.5, 1.5, (B, T, jwm.hidden_dim)).astype(np.float32)
    is_first = _flags().T.copy() if reset else None
    key = jax.random.PRNGKey(3)
    gum = jax.vmap(lambda k: jax.random.gumbel(k, (B, ROWS, CLASSES)))(jax.random.split(key, T))
    jrssm = JaxRSSM(jwm, A, dtype=jnp.float32, fused_scan_grads=False)

    def jax_loss(p):
        seq = jrssm.observe_sequence(p, jnp.asarray(obs, jnp.float32) / 255.0 - 0.5,
                                     jnp.asarray(actions), key,
                                     is_first=None if is_first is None else jnp.asarray(is_first))
        return _loss(seq.h, seq.z, seq.post_logits, jnp.asarray(w_h)), seq

    (_, jseq), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(wm)

    nets = rssm.nets
    nets.zero_grad(set_to_none=True)
    seq = rssm.observe_sequence(t(obs), t(actions), t(gum),
                                None if is_first is None else t(is_first))
    _loss(seq.h, seq.z, seq.post_logits, t(w_h)).backward()
    for name, o, r in zip(("h", "z", "post_logits"), seq, jseq):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=name)
    got = _grad_tree(nets)
    read = ("enc_conv0", "enc_conv1", "enc_conv2", "enc_conv3", "posterior_head", "gru")
    assert np.abs(got["enc_conv0"]["kernel"]).max() > 1e-3  # the encoder's backward ran
    close_trees({k: got[k] for k in read}, {k: jgrads[k] for k in read}, GRAD_RTOL,
                GRAD_ATOL)
    nets.zero_grad(set_to_none=True)


@pytest.mark.parametrize("fault", ["none", "h_seq", "z_seq"])
def test_hold_observe_fails_a_forward_its_cell_does_not_reproduce(world, monkeypatch, fault):
    """``hold_observe`` (the card's check of the posterior scan's kernels at
    the path's own operands) holds a true forward and fails one whose carried
    state is one float32 step off, or whose sample moved to another
    category."""
    _, _, rssm = world
    nets = rssm.nets
    # Like the kernel, and unlike a batched matmul, a cell computed one row at
    # a time gives each row the same numbers whatever rows share the call.
    def cell_row_by_row(x, h, *ops):
        return torch.cat([gru_cuda.gru_cell_plain(x[i:i + 1], h[i:i + 1], *ops)
                          for i in range(x.shape[0])])

    monkeypatch.setattr(gru_cuda, "gru_cell", cell_row_by_row)
    monkeypatch.setattr(gru_module, "gru_cell", cell_row_by_row)
    rng = np.random.default_rng(4)
    feats = t(rng.standard_normal((T, B, nets.feat_dim)).astype(np.float32))
    a_in = t(rng.uniform(-1, 1, (T, B, A)).astype(np.float32))
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (T, B, ROWS, CLASSES))
    gum = t((-np.log(-np.log(u))).astype(np.float32))
    with torch.no_grad():
        h_seq, z_seq, _ = observe_scan(nets, torch.zeros(B, nets.cfg.hidden_dim),
                                       torch.zeros(B, nets.cfg.latent_dim), feats, a_in, gum)
    if fault == "h_seq":
        h_seq[2, 1, 0] = torch.nextafter(h_seq[2, 1, 0], torch.tensor(2.0))
    elif fault == "z_seq":
        z = z_seq[2, 3, :CLASSES]
        z_seq[2, 3, :CLASSES] = torch.roll(z, 1)
    stats = hold_observe(nets, feats, a_in, gum, h_seq, z_seq)
    assert (stats["failures"] == []) == (fault == "none"), stats
    assert stats["near_ties"] < stats["latent_rows"]
