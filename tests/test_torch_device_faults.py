"""Two faults of the port's lifecycle across device types, repaired.

- A checkpoint whose generator states come from the other device type (a
  CPU generator's state is 5,056 bytes, a CUDA one's 16, and ``set_state``
  takes neither for the other) resumes: both streams are reseeded from
  ``train.seed`` and the restored iteration before any module is loaded,
  one line names both devices, and the iteration, the ring, the weights,
  the optimizer states and the counters come back exactly.  On the CPU the
  checkpoint's states are replaced by a CUDA-sized one; the ``cuda`` test
  crosses the card and the CPU both ways.
- A compute dtype other than bfloat16 on a CUDA device is refused when
  ``Dreamer`` is built, before a farm, a directory or ``run_meta.json``: the
  kernels take bf16 only.  On the CPU a CUDA ``torch.device`` is passed,
  which would fail later for the missing card if the check did not come
  first.

This file imports nothing of JAX, so on the card it runs with
``--noconftest``."""

import os

import numpy as np
import pytest
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.orchestrator.dreamer import RESEED_STRIDE
from dreamer_tpu_torch.utils.checkpoint import atomic_save, load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")


def config(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "env.max_episode_steps=10"] + [f"{k}={v}" for k, v in kw.items()]
    return DreamerConfig.from_yaml(SMOKE, ov)


def restored_state(d):
    """What a restore brings back, on the CPU, by name."""
    s, b = d.state, d.buf
    out = {f"wm.{k}": v for k, v in s.wm.nets.state_dict().items()}
    for name, m in (("actor", s.ac.actor), ("critic", s.ac.critic)):
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    for name, opt in (("wm_opt", s.wm.opt), ("actor_opt", s.ac.actor_opt)):
        out.update({f"{name}.mu{i}": t for i, t in enumerate(opt.mu)})
        out[f"{name}.count"] = opt.count
    out.update({"step": s.step, "obs": b.obs, "action": b.action, "reward": b.reward,
                "cont": b.cont})
    counters = (b.next_idx, b.size, d.iteration, d.farm.seed, d._eval_seed)
    return {k: v.detach().cpu() for k, v in out.items()}, counters


def same_restore(d, d2):
    (want, want_n), (got, got_n) = restored_state(d), restored_state(d2)
    assert got_n == want_n
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def reseeded(device, base):
    return (torch.Generator(device=device).manual_seed(base).get_state(),
            torch.Generator(device=device).manual_seed(base + 1).get_state())


def cuda_sized(seed: int, offset: int) -> torch.Tensor:
    """A CUDA generator's state: its seed and its Philox offset, 8 bytes each."""
    return torch.from_numpy(np.array([seed, offset], np.uint64).view(np.uint8).copy())


def test_generators_from_a_cuda_checkpoint_reseed_on_the_cpu(tmp_path, capsys):
    d = Dreamer(config(tmp_path), device="cpu")
    for _ in range(2):
        d.rollout_policy(random_policy=True)
    d.state, _ = d.trainer.train_iteration(d.state, d.buf, d.rng)
    d.iteration = 3
    path = d.save_checkpoint()
    tree = load(path)
    tree["rng"], tree["rollout_rng"] = cuda_sized(0, 40), cuda_sized(1, 12)
    atomic_save(tree, path)

    d2 = Dreamer(config(tmp_path, **{"train.seed": 7}), device="cpu")
    capsys.readouterr()
    assert d2.restore_latest()
    line = capsys.readouterr().out.strip()
    assert line.startswith("resume:") and "from a cuda device" in line and "on cpu" in line
    same_restore(d, d2)
    base = 7 + RESEED_STRIDE * 4
    assert str(base) in line
    want = reseeded("cpu", base)
    assert torch.equal(d2.rng.get_state(), want[0])
    assert torch.equal(d2.rollout_rng.get_state(), want[1])
    # The run goes on from there.
    d2.rollout_policy()
    _, metrics = d2.trainer.train_iteration(d2.state, d2.buf, d2.rng)
    assert torch.isfinite(metrics["wm/loss"])


def test_float32_on_a_cuda_device_is_refused_before_anything_is_built(tmp_path):
    cfg = config(tmp_path)
    assert cfg.runtime.compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype='float32' on a CUDA device.*bfloat16"):
        Dreamer(cfg, device=torch.device("cuda"))
    assert not os.path.exists(tmp_path / "models") and not os.path.exists(tmp_path / "logs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")],
                         ids=["card_to_cpu", "cpu_to_card"])
def test_resume_crosses_device_types(tmp_path, cuda, capsys, src, dst):
    bf16 = {"runtime.compute_dtype": "bfloat16"}
    d = Dreamer(config(tmp_path, **bf16), device=src)
    d.rollout_policy(random_policy=True)
    d.state, _ = d.trainer.wm_step(d.state, d.buf, d.rng)
    d.iteration = 2
    d.save_checkpoint()
    d2 = Dreamer(config(tmp_path, **bf16, **{"train.seed": 7}), device=dst)
    capsys.readouterr()
    assert d2.restore_latest()
    line = capsys.readouterr().out.strip()
    assert line.startswith("resume:") and f"from a {src} device" in line
    same_restore(d, d2)
    want = reseeded(dst, 7 + RESEED_STRIDE * 3)
    assert torch.equal(d2.rng.get_state(), want[0])
    assert torch.equal(d2.rollout_rng.get_state(), want[1])
    d2.rollout_policy()
    assert d2.buf.size == 2 * d2.cfg.train.sequence_length


@pytest.mark.cuda
def test_float32_is_refused_on_the_card(tmp_path, cuda):
    with pytest.raises(ValueError, match="compute_dtype='float32' on a CUDA device"):
        Dreamer(config(tmp_path), device=cuda)
    assert not os.path.exists(tmp_path / "models") and not os.path.exists(tmp_path / "logs")
