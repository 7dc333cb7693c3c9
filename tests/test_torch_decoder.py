"""The world model's new parts against the JAX package, from the same
parameters and inputs made with numpy:

- ``core.dists.categorical_kl`` against ``dreamer_tpu.core.dists``'s, on
  raw logits, float32, to 1e-6 abs/rel;
- ``WMNets.decode`` against the flax ``WMNets.decode`` at the flagship
  widths (configs/car_racer.yaml: 64x64 frames, a 4x4x256 start, four
  ConvTranspose layers), float32: the frames to 1e-5 abs/rel and the
  gradients of a weighted sum with respect to every decoder parameter and
  (h, z) to 1e-4 rel + 1e-5 abs (float32 sums in another order); in
  bfloat16 to 2e-2 abs/rel (XLA rounds after each op where the port's
  convolutions round once, as tests/test_torch_nets.py states);
- the pixel normalisation: the training table (``conv_cuda.norm_table
  ("train")``) equals JAX's ``u.astype(dtype) / 255.0 - 0.5`` on all 256
  byte values exactly, in bfloat16 and float32, the serving table equals the
  policy programs' ``(u / 255 - 0.5).astype(dtype)``, and the training paths'
  encoder reads the training table."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DTYPES, configs, f32, jax_params, port_nets, t
from dreamer_tpu.core.dists import categorical_kl as jax_categorical_kl
from dreamer_tpu.nets.wm_nets import WMNets as JaxWMNets
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.core.dists import categorical_kl
from dreamer_tpu_torch.ops.conv_cuda import encoder_forward_plain, norm_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "car_racer.yaml")
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def test_categorical_kl_matches_jax():
    rng = np.random.default_rng(0)
    p, q = (3.0 * rng.standard_normal((5, 7, 32))).astype(np.float32), \
        (3.0 * rng.standard_normal((5, 7, 32))).astype(np.float32)
    got = categorical_kl(t(p), t(q))
    assert got.shape == (5, 7) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_categorical_kl(p, q)), rtol=1e-6,
                               atol=1e-6)
    assert float(categorical_kl(t(p), t(p)).abs().max()) < 1e-6


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def flagship(request):
    jcfg, cfg = configs(FLAGSHIP, request.param)
    wm, actor = jax_params(jcfg, seed=3)
    nets, _ = port_nets(cfg, wm, actor)
    return request.param, jcfg, wm, nets, JaxWMNets(jcfg.wm, dtype=DTYPES[request.param][0])


def test_decoder_matches_flax(flagship):
    dtype, jcfg, wm, nets, jnets = flagship
    rng = np.random.default_rng(1)
    n, c = 3, jcfg.wm
    h = np.tanh(rng.standard_normal((n, c.hidden_dim))).astype(np.float32)
    z = np.eye(c.latent_classes, dtype=np.float32)[
        rng.integers(0, c.latent_classes, (n, c.latent_rows))].reshape(n, -1)
    ref = jnets.apply({"params": wm}, jnp.asarray(h), jnp.asarray(z), method=JaxWMNets.decode)
    out = nets.decode(t(h), t(z))
    assert out.shape == (n, 64, 64, 3) and out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(ref), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype != "float32":
        return

    w = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)

    def jax_loss(p, h, z):
        x = jnets.apply({"params": p}, h, z, method=JaxWMNets.decode)
        return jnp.sum(x * w) + jnp.sum(x ** 2)

    jg_p, jg_h, jg_z = jax.grad(jax_loss, argnums=(0, 1, 2))(wm, jnp.asarray(h), jnp.asarray(z))
    ht, zt = t(h).requires_grad_(), t(z).requires_grad_()
    x = nets.decode(ht, zt)
    nets.zero_grad(set_to_none=True)
    (torch.sum(x * t(w)) + torch.sum(x ** 2)).backward()
    for got, want, name in ((ht.grad, jg_h, "h"), (zt.grad, jg_z, "z")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    entries = [(path, p.grad, a, b) for path, p, a, b in bridge._wm_entries(nets)
               if path[0].startswith(("upscaler", "dec_conv"))]
    assert len(entries) == 3 * 2 + 4 * 2
    for path, g, _, to_flax in entries:
        want = jg_p
        for k in path:
            want = want[k]
        np.testing.assert_allclose(to_flax(g.numpy()), np.asarray(want), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="/".join(path))
    nets.zero_grad(set_to_none=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normalisation_tables_equal_jax_on_every_byte(dtype):
    jd, td = DTYPES[dtype]
    u = jnp.arange(256, dtype=jnp.uint8)
    train = np.asarray(u.astype(jd) / 255.0 - 0.5, np.float32)
    serve = np.asarray((u.astype(jnp.float32) / 255.0 - 0.5).astype(jd), np.float32)
    np.testing.assert_array_equal(norm_table("train", td).float().numpy(), train)
    np.testing.assert_array_equal(norm_table("serve", td).float().numpy(), serve)
    assert norm_table("train", td).dtype == td
    # The two roundings differ in bf16 (for half the bytes) and not in f32.
    assert (np.sum(train != serve) > 100) == (dtype == "bfloat16")


def test_training_paths_encode_through_the_training_table(flagship):
    dtype, jcfg, wm, nets, _ = flagship
    rng = np.random.default_rng(2)
    obs = t(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    ws, bs = nets.encoder_weights()
    want = encoder_forward_plain(obs, ws, bs, norm_table("train", DTYPES[dtype][1]))
    assert torch.equal(nets.encode_obs(obs, train=True), want)
    serve = nets.encode_obs(obs)
    assert torch.equal(serve, want) == (dtype == "float32")
