"""The port's ``Dreamer`` (``dreamer_tpu_torch.orchestrator``) at the
``configs/fake_smoke.yaml`` widths in float32 on the CPU, held against the JAX
package's ``Dreamer``.

- Random-policy kickstart rounds fill the port's replay ring exactly as
  JAX's: the frames, actions, continues and episode-start flags equal, the
  rewards (symlog applied at the write) to 2 ulp, the write head, fill level
  and the farm's seed counter equal, in both auto-reset modes with episodes
  short enough to reset.  The JAX weights go into the port through
  ``bridge`` (a random policy's ring does not depend on them).  The rewards
  differ because XLA's float32 log1p is up to 2 ulp off the correctly
  rounded value and torch's up to 1 (``test_symlog_ulps``).  The policy's
  rollout and eval are held against JAX's in
  ``test_torch_orchestrator_policy.py``.
- The rollout policy acts with the learner's live modules: one
  ``train_iteration`` changes its action, which equals that of a ``Policy``
  built on copies of the learner's modules, bit for bit.
- The rest of the lifecycle's bookkeeping as JAX's tests check it: the live
  ``nu_override``, a graceful stop (checkpoint, ``stopped``) and its resume,
  a fresh start deleting a stale ``kickstart.json``, batched eval
  compacting episodes of mixed lengths, the knob that is not ported, an
  overlapped rollout without the host-local actor and a float32 config on a
  CUDA device (refused when ``Dreamer`` is built)."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.core.math import symlog as jax_symlog
from dreamer_tpu.orchestrator import Dreamer as JaxDreamer
from dreamer_tpu.train.step import Trainer as JaxTrainer
from _torch_parity import random_like
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.math import symlog
from dreamer_tpu_torch.envs import EnvFarm, FakeEnv
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.train.step import Policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
ROUNDS = 3
JAX_INIT = JaxTrainer.init_state


def overrides(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "train.training_iterations=2", "train.random_iterations=1",
          "train.eval_every=100", "train.checkpoint_every=100", "train.eval_episodes=1",
          "train.final_eval_episodes=1", "env.max_episode_steps=10"]
    return ov + [f"{k}={v}" for k, v in kw.items()]


def port(tmp, **kw):
    return Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp, **kw)), device="cpu")


def random_init_state(self, key):
    """A JAX ``DreamerState`` of ``Trainer.init_state``'s structure from its
    traced shapes alone (compiling flax's eager init takes half a minute on
    the CPU): every parameter random (``random_like``), the target critic a
    copy of the critic, optimizer states and counters zero."""
    shapes = jax.eval_shape(JAX_INIT.__get__(self), key)
    state = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(0)
    critic = random_like(shapes.ac.critic_params, rng)
    return state._replace(
        wm=state.wm._replace(params=random_like(shapes.wm.params, rng)),
        ac=state.ac._replace(actor_params=random_like(shapes.ac.actor_params, rng),
                             critic_params=critic, target_critic_params=critic))


@pytest.mark.parametrize("next_step", [False, True], ids=["same_step", "next_step"])
def test_kickstart_ring_equals_jax(tmp_path, monkeypatch, next_step):
    kw = {"env.next_step_autoreset": next_step, "env.max_episode_steps": 20}
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jd = JaxDreamer(JaxConfig.from_yaml(SMOKE, overrides(tmp_path / "jax", **kw)))
    d = port(tmp_path / "port", **kw)
    bridge.load_dreamer_state(d.state, jax.tree.map(np.asarray, jd.state))
    for _ in range(ROUNDS):
        jd.rollout_policy(random_policy=True)
        d.rollout_policy(random_policy=True)
    jb, b = jd.buf, d.buf
    for name in ("obs", "action", "cont") + (("first",) if next_step else ()):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    # XLA's float32 log1p lies up to 2 ulp from the correctly rounded value
    # and torch's up to 1, and they differ by up to 2 (test_symlog_ulps).
    np.testing.assert_array_max_ulp(b.reward.numpy(), np.asarray(jb.reward), maxulp=2)
    assert (b.first is None) == (jb.first is None) == (not next_step)
    assert (b.next_idx, b.size) == (int(jb.next_idx), int(jb.size)) == (0 + ROUNDS * 16, ROUNDS * 16)
    assert d.farm.seed == jd.farm.seed == 2 + 2 * 2   # 2 envs, each reset after 20 steps
    assert float(b.cont.min()) == 0.0


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_symlog_ulps():
    """The evidence for the ring's 2 ulp: on 200,000 rewards in [-1.5, 1.5]
    (the fake env's range), JAX's float32 symlog lies up to 2 ulp from the
    correctly rounded value (float64, rounded once), the port's up to 1, and
    the two up to 2 apart."""
    x = np.random.default_rng(0).uniform(-1.5, 1.5, 200_000).astype(np.float32)
    exact = (np.sign(x.astype(np.float64)) * np.log1p(np.abs(x.astype(np.float64))))
    exact = exact.astype(np.float32)
    got_jax = np.asarray(jax.jit(jax_symlog)(x))
    got_port = symlog(torch.from_numpy(x)).numpy()
    assert _ulps(got_jax, exact).max() == 2
    assert _ulps(got_port, exact).max() <= 1
    assert _ulps(got_jax, got_port).max() <= 2


def test_policy_acts_with_the_learners_live_modules(tmp_path):
    d = port(tmp_path)
    for _ in range(2):
        d.rollout_policy(random_policy=True)
    c, n = d.cfg.wm, 4
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(n, c.hidden_dim, generator=gen)
    z = torch.nn.functional.one_hot(torch.randint(0, c.latent_classes, (n, c.latent_rows),
                                                  generator=gen), c.latent_classes)
    z = z.float().reshape(n, -1)
    obs = torch.randint(0, 256, (n, *c.obs_size, 3), dtype=torch.uint8, generator=gen)
    a = torch.rand(n, d.cfg.env.action_dim, generator=gen) * 2 - 1
    noise = d.policy.sample_noise(n, gen)
    done = torch.tensor([False, True, False, False])

    def act(policy):
        return (policy.policy_act(h, z, deterministic=True),
                *policy.policy_act_observe(h, z, a, obs, done, noise))

    before = act(d.policy)
    d.state, _ = d.trainer.train_iteration(d.state, d.buf, d.rng)
    after = act(d.policy)
    assert not torch.equal(before[0], after[0])
    assert not torch.equal(before[3], after[3])
    copies = Policy(d.cfg, nets=copy.deepcopy(d.trainer.rssm.nets),
                    actor=copy.deepcopy(d.state.ac.actor))
    for x, y in zip(after, act(copies)):
        assert torch.equal(x, y)


def test_traced_nu_picks_up_a_new_override(tmp_path):
    d = port(tmp_path, **{"runtime.traced_nu": True})
    seen, real = [], d.trainer.train_iteration

    def record(state, ring, gen, nu=None):
        seen.append(float(nu))
        if len(seen) == 1:
            with open(os.path.join(d.cfg.runtime.log_dir, "nu_override"), "w") as f:
                f.write("0.25\n")
        return real(state, ring, gen, nu)

    d.trainer.train_iteration = record
    d.train(progress=False)
    assert seen == [pytest.approx(d.cfg.agent.nu), 0.25]
    rows = [r for r in _csv(d) if r.get("ac/nu")]
    assert [float(r["ac/nu"]) for r in rows] == [pytest.approx(d.cfg.agent.nu), 0.25]


def _csv(d):
    import csv

    with open(os.path.join(d.cfg.runtime.log_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_request_stop_checkpoints_and_resume_continues(tmp_path):
    d = port(tmp_path, **{"train.training_iterations": 4})
    real = d.trainer.train_iteration

    def stop_at_two(*args):
        out = real(*args)
        if int(out[0].step) == 2:
            d.request_stop()
        return out

    d.trainer.train_iteration = stop_at_two
    d.train(progress=False)
    assert d.stopped and d.iteration == 2 and d.ckpt.latest_step() == 2
    assert d.metrics.wm_losses and os.path.exists(
        os.path.join(d.cfg.runtime.log_dir, "training_logs.npz"))
    d.close()

    d2 = port(tmp_path, **{"train.training_iterations": 4})
    kicked = []
    real_rollout = d2.rollout_policy
    d2.rollout_policy = lambda random_policy=False: (kicked.append(random_policy),
                                                     real_rollout(random_policy))[1]
    d2.train(resume=True, progress=False)
    assert not d2.stopped and d2.iteration == 4 and int(d2.state.step) == 4
    assert kicked == [False, False]   # no kickstart, no re-prime: the ring was restored


def test_stop_during_kickstart_records_its_progress(tmp_path):
    d = port(tmp_path, **{"train.random_iterations": 3})
    d.request_stop()
    d.train(progress=False)
    assert d.stopped and d.iteration == 0 and d.ckpt.latest_step() == 0
    with open(d._kickstart_path()) as f:
        assert json.load(f) == {"rounds_done": 0}


def test_fresh_start_deletes_a_stale_kickstart_sidecar(tmp_path):
    d = port(tmp_path, **{"train.random_iterations": 2})
    os.makedirs(d.cfg.runtime.checkpoint_dir, exist_ok=True)
    with open(d._kickstart_path(), "w") as f:
        json.dump({"rounds_done": 99}, f)
    rounds = []
    real = d.rollout_policy
    d.rollout_policy = lambda random_policy=False: (rounds.append(random_policy),
                                                    real(random_policy))[1]
    d.train(progress=False)
    assert rounds == [True, True, False, False]
    with open(d._kickstart_path()) as f:
        assert json.load(f) == {"rounds_done": 2}


def test_batched_eval_compacts_episodes_of_mixed_lengths(tmp_path):
    d = port(tmp_path)
    lens, steps = [3, 6, 11], []

    class Counted(FakeEnv):
        def step(self, action):
            steps.append(self.episode_len)
            return super().step(action)

    rows = []
    real = d.policy.policy_observe
    d.policy.policy_observe = lambda z, h, *a: (rows.append(h.shape[0]), real(z, h, *a))[1]
    d._eval_farm = EnvFarm([lambda n=n: Counted(obs_size=(32, 32), episode_len=n)
                            for n in lens], seed=0)
    reward = d.evaluate_agent(3, max_steps=50)
    assert np.isfinite(reward) and reward != 0.0
    assert sorted(steps) == sorted(sum(([n] * n for n in lens), []))
    # The observe after a step runs on the rows before that step's compaction:
    # 3 rows until the first episode ends (step 3), 2 until the second (step
    # 6), then 1; the last step ends every episode and observes nothing.
    assert rows == [3, 3, 3, 2, 2, 2, 1, 1, 1, 1]
    assert d._eval_seed == d.cfg.train.seed + 10_000 + 3
    # One episode at a time on the eval env, each from the next seed.
    assert np.isfinite(d.evaluate_agent(2, max_steps=5, batched=False))
    assert d._eval_seed == d.cfg.train.seed + 10_000 + 5


# knob: (device, the refusal).  A mesh whose n x m is not the world size (one
# process here; the model axis itself runs).  An overlapped rollout without
# the host-local actor is refused as JAX refuses it.  A float32 config is
# refused on a CUDA device (its kernels take bf16), which the CPU test names
# without launching anything.
REFUSED = {"runtime.mesh_shape=[1, 2]": ("cpu", "needs 2 ranks, the world has 1"),
           "runtime.async_rollout=true": ("cpu", "requires runtime.rollout_device='cpu'"),
           "runtime.compute_dtype=float32": ("cuda", "bfloat16 only")}


@pytest.mark.parametrize("knob", list(REFUSED))
def test_unported_knobs_raise(tmp_path, knob):
    device, match = REFUSED[knob]
    cfg = DreamerConfig.from_yaml(SMOKE, overrides(tmp_path) + [knob])
    with pytest.raises(ValueError, match=match):
        Dreamer(cfg, device=torch.device(device))


def test_run_collects_frames(tmp_path):
    d = port(tmp_path)
    frames = []
    total = d.run(env=FakeEnv(obs_size=(32, 32), episode_len=5), env_seed=3, frames=frames)
    assert np.isfinite(total) and len(frames) == 5 and frames[0].shape == (32, 32, 3)
