"""``python -m dreamer_tpu_torch.cli.train --env-maker MODULE:FUNCTION`` on the
CPU.

- ``--env-maker gymnasium:make`` trains ``LunarLander-v3`` from pixels (a
  pixel-from-render id: ActionRepeat -> PixelObservation -> Resize over
  gymnasium's env) at the ``configs/fake_smoke.yaml`` widths, with its 2
  actions, on the smallest schedule (1 kickstart round, 1 iteration), its
  rollout in ``AsyncEnvFarm``'s spawned workers (``env.async_envs=true``),
  each of which imports the maker by name: the losses are finite, the
  checkpoint is written, and the ring's first frame of each env is the JAX
  ``make_env``'s reset frame for that env's seed.
- Without ``--env-maker`` a real id fails in ``main`` before anything is
  built or written, and the message gives the whole command."""

import math
import os

import numpy as np
import pytest

from dreamer_tpu.envs import make_env as jax_make_env
from dreamer_tpu_torch.cli.train import main
from dreamer_tpu_torch.utils.checkpoint import load
from test_torch_cli import SMOKE, dirs, rows

LUNAR = ["env.env_id=LunarLander-v3", "env.action_dim=2", "env.max_episode_steps=20",
         "train.random_iterations=1", "train.training_iterations=1",
         "train.eval_episodes=1", "train.final_eval_episodes=1"]


def test_cli_trains_lunar_lander_through_gymnasium_make(tmp_path):
    argv = ["--config", SMOKE, "--device", "cpu", "--env-maker", "gymnasium:make",
            "--overrides", *dirs(tmp_path), *LUNAR, "env.async_envs=true"]
    assert math.isfinite(main(argv))
    done = rows(tmp_path / "logs")
    assert [int(r["iteration"]) for r in done] == [1]
    for k in ("wm/loss", "ac/loss_actor", "ac/loss_critic", "perf/env_steps_per_s"):
        assert math.isfinite(float(done[0][k])), k
    ring = load(str(tmp_path / "models" / "ckpt_1"))["buffer"]
    assert tuple(ring["obs"].shape[2:]) == (32, 32, 3) and ring["action"].shape[-1] == 2
    for env in range(2):
        ref = jax_make_env("LunarLander-v3", obs_size=(32, 32), action_repeat=1,
                           max_episode_steps=20)
        want, _ = ref.reset(seed=env)   # the farm's seed 0 plus the env's index
        ref.close()
        np.testing.assert_array_equal(ring["obs"][env, 0].numpy(), want)


def test_a_real_env_without_a_maker_fails_before_anything_is_written(tmp_path, capsys):
    argv = ["--config", SMOKE, "--device", "cpu", "--overrides", *dirs(tmp_path), *LUNAR]
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "--env-maker gymnasium:make" in err
    assert f"python -m dreamer_tpu_torch.cli.train --config {SMOKE} --env-maker gymnasium:make" in err
    assert not os.path.exists(tmp_path / "models") and not os.path.exists(tmp_path / "logs")
