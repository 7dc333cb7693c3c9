"""The committed flagship export, ``checkpoints/carracer_r3/agent_best``
(``best.json``: eval reward 567.16 at iteration 9750), driving a real
``CarRacing-v3`` episode through both packages on the CPU in float32: the
JAX policy programs on the JAX wrapper stack (OpenCV's resize), the port's
``Policy`` on the port's stack over ``gymnasium:make``.  Both take the JAX
noise (the rollout stream ``PRNGKey(train.seed + 1)``, one split a policy
call, as ``Dreamer._run_episode`` draws it), and the episode's seed is the
JAX ``Dreamer``'s first unbatched eval seed.

(a) Teacher-forced: both stacks are stepped with JAX's deterministic
    actions.  Every frame is equal exactly, every reward and flag equal, so
    the episode rewards are equal; the port's own action agrees with JAX's
    to ``ACTION_TOL`` at every step, and the sampled latents are equal.
(b) Closed loop: the port acts on its own from the same seed and noise.  Its
    episode reward stands within ``CLOSED_LOOP_TOL`` of JAX's.

Marked ``slow`` (a 250-step episode three times over at the flagship
widths)."""

import numpy as np
import pytest
import torch

from dreamer_tpu.envs import make_env as jax_make_env
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.envs import make_env
from dreamer_tpu_torch.train import Policy
from test_torch_bridge import agent_best  # noqa: F401  (the fixture)
from test_torch_orchestrator_policy import JaxDraws

pytestmark = pytest.mark.slow

ENV_ID = "CarRacing-v3"
# float32 sums over the 4096-wide features in another order: measured
# 1.28e-6 at most over this episode.
ACTION_TOL = 1e-5
# Closed loop, the actions' float32 differences move the car by a hair; the
# Box2D physics and the track's tile contacts amplify it until a frame
# differs (after 13 to 45 agent steps) and the two episodes part.  Measured
# port - JAX episode rewards on seeds 10,001-10,004 and this test's 10,043:
# -9.09, -12.58, +27.03, -22.01 and +16.06 (JAX's own 500.63 to 683.13).
# The bound is 1.5 times the largest.
CLOSED_LOOP_TOL = 40.0


def stacks(cfg):
    kw = dict(obs_size=tuple(cfg.wm.obs_size), action_repeat=cfg.env.action_repeat,
              crop_rows=cfg.env.crop_rows)
    return make_env(ENV_ID, base_make="gymnasium:make", **kw), jax_make_env(ENV_ID, **kw)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def players(agent_best):  # noqa: F811
    jcfg, cfg, tree = agent_best
    policy = Policy(cfg, device="cpu")
    bridge.load_wm(policy.rssm.nets, tree["wm"])
    bridge.load_actor(policy.actor, tree["actor"])
    return jcfg, cfg, tree, policy, JaxTrainer(jcfg, jit=True)


@pytest.fixture(scope="module")
def teacher_forced(players):
    """Episode (a): both stacks stepped by JAX's deterministic actions, the
    port's policy observing the same frames and actions."""
    jcfg, cfg, tree, policy, trainer = players
    wm, actor = tree["wm"], tree["actor"]
    env, ref = stacks(cfg)
    draws = JaxDraws(jcfg)
    out = {"frames_equal": True, "steps_equal": True, "latents_equal": True, "errs": [],
           "reward": 0.0, "reward_ref": 0.0, "frames_ref": []}
    try:
        (obs, _), (obs_ref, _) = env.reset(seed=SEED(jcfg)), ref.reset(seed=SEED(jcfg))
        out["frames_equal"] &= np.array_equal(obs, obs_ref)
        key = draws.next()
        h_j, z_j = trainer.policy_reset(wm, obs_ref[None], key)
        h_p, z_p = policy.policy_reset(t(obs[None]), draws.gumbel(1, key))
        for _ in range(1000):
            a_j = trainer.policy_act(actor, h_j, z_j, draws.next(), deterministic=True)
            a_p = policy.policy_act(h_p, z_p, deterministic=True)
            out["errs"].append(float(np.abs(a_p.numpy() - np.asarray(a_j)).max()))
            a = np.asarray(a_j)[0]
            obs, reward, term, trunc, _ = env.step(a)
            obs_ref, reward_ref, term_ref, trunc_ref, _ = ref.step(a)
            out["frames_equal"] &= np.array_equal(obs, obs_ref)
            out["frames_ref"].append(obs_ref)
            out["steps_equal"] &= (reward, term, trunc) == (reward_ref, term_ref, trunc_ref)
            out["reward"] += float(reward)
            out["reward_ref"] += float(reward_ref)
            if term or trunc:
                break
            key = draws.next()
            z_j, h_j = trainer.policy_observe(wm, z_j, h_j, a_j, obs_ref[None], key)
            z_p, h_p = policy.policy_observe(z_p, h_p, t(a_j), t(obs[None]),
                                             draws.gumbel(1, key))
            out["latents_equal"] &= np.array_equal(np.rint(z_p.numpy()),
                                                   np.rint(np.asarray(z_j)))
    finally:
        env.close()
        ref.close()
    return out


def SEED(jcfg):
    """The JAX ``Dreamer``'s first unbatched eval episode's seed."""
    return jcfg.train.seed + 10_001


def test_teacher_forced_episode_equals_jax(teacher_forced):
    out = teacher_forced
    errs = out["errs"]
    print(f"teacher-forced: {len(errs)} steps, reward {out['reward']:.4f} (port stack) "
          f"{out['reward_ref']:.4f} (JAX stack), action max abs err {max(errs):.3g} "
          f"at step {int(np.argmax(errs))}")
    assert out["frames_equal"] and out["steps_equal"] and out["latents_equal"]
    assert out["reward"] == out["reward_ref"]
    assert len(errs) == 250   # CarRacing's 1000 frames at an action repeat of 4
    assert max(errs) <= ACTION_TOL


def test_closed_loop_episode_reward_beside_jax(players, teacher_forced):
    jcfg, cfg, tree, policy, trainer = players
    env, ref = stacks(cfg)
    ref.close()
    draws = JaxDraws(jcfg)
    try:
        obs, _ = env.reset(seed=SEED(jcfg))
        h, z = policy.policy_reset(t(obs[None]), draws.gumbel(1))
        total, steps, parted = 0.0, 0, None
        frames_ref = teacher_forced["frames_ref"]
        for _ in range(1000):
            draws.next()   # JAX splits a key for a deterministic action too
            a = policy.policy_act(h, z, deterministic=True)
            obs, reward, term, trunc, _ = env.step(a.numpy()[0])
            if parted is None and (steps >= len(frames_ref)
                                   or not np.array_equal(obs, frames_ref[steps])):
                parted = steps
            total += float(reward)
            steps += 1
            if term or trunc:
                break
            z, h = policy.policy_observe(z, h, a, t(obs[None]), draws.gumbel(1))
    finally:
        env.close()
    print(f"closed loop: {steps} steps, port reward {total:.4f}, JAX reward "
          f"{teacher_forced['reward_ref']:.4f}, the first frame apart at step {parted}")
    assert abs(total - teacher_forced["reward_ref"]) <= CLOSED_LOOP_TOL
