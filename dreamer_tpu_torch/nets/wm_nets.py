"""The world-model networks (``dreamer_tpu/nets/wm_nets.py``).

- conv encoder ``enc_conv0..3``: 4x [Conv(k4, s2, p1) + SiLU], channels
  3 -> f1 -> f2 -> 2*f2 -> 4*f2; weights OIHW.  It runs as one fused kernel
  (``ops.conv_cuda``) that also normalises the uint8 frames, so
  ``encode_obs`` takes uint8 frames where the JAX method takes frames
  already normalised to [-0.5, 0.5].  Two normalisation tables are made once:
  serving's single rounding and the training paths' double rounding
  (``conv_cuda.norm_table``).  ``encode_obs`` is differentiable in the conv
  parameters (``conv_cuda.encode``).
- posterior head: Dense(enc_hidden)+LN+SiLU -> Dense(rows*classes) on
  [features ‖ h].
- GRU: h' = GRU([flat(z) ‖ a], h).
- dynamics (prior) head: MLP h -> rows*classes logits.
- reward head: MLP [h ‖ flat(z)] -> reward_buckets twohot logits.
- continue head: MLP [h ‖ flat(z)] -> 1 logit.
- decoder: Dense(dec_hidden)+LN+SiLU -> Dense(4*df2*h/16*w/16)+SiLU on
  [h ‖ flat(z)], reshaped to (h/16, w/16, 4*df2), then 4x [ConvTranspose(k4,
  s2) + SiLU] with a final tanh instead: channels 4*df2 -> 2*df2 -> df2 ->
  df1 -> 3.  The JAX package has no kernel here, so plain PyTorch serves on
  both devices: flax's ``ConvTranspose(padding="SAME")`` is
  ``conv_transpose2d(stride=2, padding=1)`` on its kernel flipped in both
  spatial axes and laid out (in, out, kh, kw), the layout ``DecoderConv``
  keeps.  Its output stays NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamer_tpu_torch.config import WorldModelConfig
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.nets.layout import KernelLayout
from dreamer_tpu_torch.nets.mlp import MLP, Dense, LayerNorm, lecun_normal_
from dreamer_tpu_torch.ops.conv_cuda import encode, encoder_kernel_layout, norm_table
from dreamer_tpu_torch.ops.imagine_cuda import layer_operands


class EncoderConv(nn.Module):
    """Parameters of one k4/s2/p1 conv: ``weight`` (Co, Ci, 4, 4), ``bias`` (Co,)."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            lecun_normal_(self.weight, 16 * cin, generator)


class DecoderConv(nn.Module):
    """One flax ``ConvTranspose((4, 4), strides=2, padding="SAME")``:
    ``weight`` (Ci, Co, 4, 4) is flax's (4, 4, Ci, Co) kernel flipped in both
    spatial axes, ``bias`` (Co,); computed in the compute dtype, NCHW."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            lecun_normal_(self.weight, 16 * cin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2, padding=1)


class WMNets(nn.Module):
    def __init__(self, cfg: WorldModelConfig, action_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        f1, f2 = cfg.encoder_filters_1, cfg.encoder_filters_2
        chans = [3, f1, f2, 2 * f2, 4 * f2]
        self.enc_convs = nn.ModuleList(EncoderConv(chans[i], chans[i + 1], generator)
                                       for i in range(4))
        self.feat_dim = (cfg.obs_size[0] // 16) * (cfg.obs_size[1] // 16) * chans[-1]
        self.posterior_head = MLP(self.feat_dim + cfg.hidden_dim, [cfg.encoder_hidden],
                                  cfg.latent_dim, dtype, generator)
        self.gru = GRUCell(cfg.latent_dim + action_dim, cfg.hidden_dim, dtype, generator)
        H, Z = cfg.hidden_dim, cfg.latent_dim
        self.dyn_head = MLP(H, [cfg.dyn_hidden_1, cfg.dyn_hidden_2], Z, dtype, generator)
        self.reward_head = MLP(H + Z, [cfg.rew_hidden_1, cfg.rew_hidden_2],
                               cfg.reward_buckets, dtype, generator)
        self.cont_head = MLP(H + Z, [cfg.cont_hidden_1, cfg.cont_hidden_2], 1, dtype,
                             generator)
        df1, df2 = cfg.decoder_filters_1, cfg.decoder_filters_2
        self.dec_start = (cfg.obs_size[0] // 16, cfg.obs_size[1] // 16, 4 * df2)
        self.upscaler_1 = Dense(H + Z, cfg.decoder_hidden, dtype, generator)
        self.upscaler_ln = LayerNorm(cfg.decoder_hidden, dtype)
        self.upscaler_2 = Dense(cfg.decoder_hidden, self.dec_start[0] * self.dec_start[1]
                                * self.dec_start[2], dtype, generator)
        dec = [4 * df2, 2 * df2, df2, df1, 3]
        self.dec_convs = nn.ModuleList(DecoderConv(dec[i], dec[i + 1], dtype, generator)
                                       for i in range(4))
        self.register_buffer("serve_norm", norm_table("serve", dtype), persistent=False)
        self.register_buffer("train_norm", norm_table("train", dtype), persistent=False)
        self._enc_layout = KernelLayout(lambda *p: encoder_kernel_layout(
            p[0::2], p[1::2], self.dtype))
        self._dyn_layout = KernelLayout(lambda *p: layer_operands(p, self.dtype))

    def encoder_params(self):
        """The conv encoder's parameters, (w0, b0, ..., w3, b3)."""
        return [t for c in self.enc_convs for t in (c.weight, c.bias)]

    def encoder_weights(self):
        """The encoder kernel's operands (HWIO weights, float32 biases), made
        once per weight load."""
        return self._enc_layout.get(*self.encoder_params())

    def imagine_weights(self):
        """The world model's operands of the imagine kernel: the GRU cell's
        kernel layout, then the dynamics head's Dense rows and LayerNorms
        (``ops.imagine_cuda.layer_operands``).  Made once per weight load."""
        d = self.dyn_head
        dyn = self._dyn_layout.get(
            d.denses[0].weight, d.denses[0].bias, d.norms[0].scale, d.norms[0].bias,
            d.denses[1].weight, d.denses[1].bias, d.norms[1].scale, d.norms[1].bias,
            d.denses[2].weight, d.denses[2].bias)
        return (*self.gru.kernel_weights(), *dyn)

    def prepare_kernels(self) -> None:
        """Make the kernel-layout weight copies now (after a load) rather than
        on the first call."""
        self.encoder_weights()
        self.imagine_weights()

    def encode_obs(self, obs_u8: torch.Tensor, train: bool = False) -> torch.Tensor:
        """uint8 frames (..., H, W, 3) -> flat features (..., F) in the
        compute dtype, flattened in (h, w, c) order; differentiable in the
        conv parameters.  ``train`` normalises the frames as the training
        paths do (``norm_table("train")``), else as serving does."""
        lead = obs_u8.shape[:-3]
        x = obs_u8.reshape((-1,) + tuple(obs_u8.shape[-3:])).contiguous()
        table = self.train_norm if train else self.serve_norm
        return encode(x, table, self.encoder_weights(),
                      self.encoder_params()).reshape(lead + (-1,))

    def posterior_logits(self, feat: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """[features ‖ h] -> (..., rows, classes) latent logits."""
        x = torch.cat([feat.to(self.dtype), h.to(self.dtype)], dim=-1)
        logits = self.posterior_head(x)
        return logits.reshape(logits.shape[:-1] + (self.cfg.latent_rows,
                                                   self.cfg.latent_classes))

    def gru_step(self, z_flat: torch.Tensor, action: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
        """h' = GRU([flat(z) ‖ a], h), in the compute dtype."""
        x = torch.cat([z_flat, action], dim=-1)
        lead = x.shape[:-1]
        out = self.gru(x.reshape(-1, x.shape[-1]), h.reshape(-1, h.shape[-1]))
        return out.reshape(lead + (self.cfg.hidden_dim,))

    def prior_logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = self.dyn_head(h.to(self.dtype))
        return logits.reshape(logits.shape[:-1] + (self.cfg.latent_rows,
                                                   self.cfg.latent_classes))

    def reward_logits(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        return self.reward_head(torch.cat([h, z_flat], dim=-1).to(self.dtype))

    def cont_logit(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        return self.cont_head(torch.cat([h, z_flat], dim=-1).to(self.dtype))

    def decode(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        """(h, z) -> the reconstructed frame's mean in [-1, 1], (..., H, W, 3)
        in the compute dtype."""
        x = torch.cat([h, z_flat], dim=-1).to(self.dtype)
        lead = x.shape[:-1]
        x = F.silu(self.upscaler_ln(self.upscaler_1(x)))
        x = F.silu(self.upscaler_2(x))
        x = x.reshape((-1,) + self.dec_start).permute(0, 3, 1, 2)
        for conv in self.dec_convs[:-1]:
            x = F.silu(conv(x))
        x = torch.tanh(self.dec_convs[-1](x)).permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[-3:])
