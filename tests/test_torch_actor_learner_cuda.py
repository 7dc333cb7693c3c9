"""The host-local actor's weight wire (``orchestrator.broadcast``) and, on the
card, the actor-learner split at the ``configs/fake_smoke.yaml`` widths in
bfloat16.

- The wire on the CPU: ``flatten`` casts each tensor to the wire dtype
  before one concatenation and returns a host tensor; ``unflatten`` copies
  the slices back in order, upcast, and refuses a wire of another length.
- On the card (``cuda``): a CUDA learner's broadcast is its weights rounded
  to bfloat16 and back, exactly, in float32 on the CPU; a host-local actor's
  rollout round and eval launch no kernel, while its one ring write lands on
  the card.

This file imports nothing of JAX, so on the card it runs with
``--noconftest``."""

import os

import pytest
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer, broadcast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
BF16_CARD = {"runtime.rollout_device": "cpu", "runtime.compute_dtype": "bfloat16",
             "runtime.broadcast_dtype": "bfloat16"}


def config(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "env.max_episode_steps=10"] + [f"{k}={v}" for k, v in kw.items()]
    return DreamerConfig.from_yaml(SMOKE, ov)


def actor_weights(d):
    return [*d.policy.rssm.nets.parameters(), *d.policy.actor.parameters()]


@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_the_wire_round_trips_through_the_wire_dtype(wire):
    gen = torch.Generator().manual_seed(0)
    src = [torch.randn(3, 5, generator=gen), torch.randn(7, generator=gen),
           torch.randn(2, 2, 2, generator=gen)]
    flat = broadcast.flatten(src, wire)
    assert flat.dtype == wire and flat.device.type == "cpu" and flat.shape == (15 + 7 + 8,)
    dst = [torch.empty_like(t) for t in src]
    broadcast.unflatten(flat, dst)
    for s, d in zip(src, dst):
        assert torch.equal(d, s.to(wire).float())
    with pytest.raises(ValueError, match="the wire holds 30 values, the actor 29"):
        broadcast.unflatten(flat, dst[:2] + [torch.empty(7)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_broadcast_from_the_card_is_its_weights_in_bfloat16(tmp_path, cuda):
    d = Dreamer(config(tmp_path, **BF16_CARD), device=cuda)
    d._refresh_actor()
    for a, w in zip(actor_weights(d), d._learner_weights(), strict=True):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        assert torch.equal(a, w.detach().to(torch.bfloat16).float().cpu())
    d.close()


@pytest.mark.cuda
def test_a_host_actor_round_launches_no_kernel(tmp_path, cuda):
    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda, gru_scan_cuda, imagine_cuda

    kernels = (gru_cuda.gru_cell, conv_cuda.encoder_forward, gru_scan_cuda.gru_scan,
               imagine_cuda.imagine_rollout)
    d = Dreamer(config(tmp_path, **BF16_CARD), device=cuda)
    d.rollout_policy(random_policy=True)
    for k in kernels:
        k.launches = 0
    d.rollout_policy(random_policy=False)
    d.evaluate_agent(2, max_steps=5)
    assert [k.launches for k in kernels] == [0, 0, 0, 0]
    assert d.buf.obs.is_cuda and d.buf.size == 2 * d.cfg.train.sequence_length
    d.close()
