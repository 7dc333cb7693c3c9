"""The port's config overrides and flat reference schema against the JAX
package's ``dreamer_tpu.config``: for every shipped config and a list of
overrides, the resulting ``to_dict()`` (values and their types) or the type
of the raised error is the same; ``from_flat_dict`` and a flat YAML file load
to the same config.  Exact equality."""

import glob
import os

import pytest

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu_torch.config import DreamerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))

OVERRIDES = [
    "agent.nu=3e-3",                  # YAML 1.1 string, coerced to float
    "agent.nu=1e-2",
    "agent.nu=0.5",
    "agent.nu=2",                     # an int into a float field stays as parsed
    "train.eval_every=1e2",           # string, integral: coerced to int
    "train.eval_every=12.0",          # float, integral: coerced to int
    "train.eval_every=1.23e1",        # string, not integral: ValueError
    "train.eval_every=12.3",          # float, not integral: ValueError
    "train.eval_every=ten",           # ValueError
    "agent.nu=not_a_number",          # ValueError
    "runtime.traced_nu=true",
    "runtime.traced_nu=False",
    "runtime.traced_nu=yes",
    "runtime.traced_nu=maybe",        # a string into a bool field: ValueError
    "wm.betas=[0.8, 0.99]",           # lists become tuples
    "runtime.mesh_shape=[4, 1]",
    "runtime.mesh_shape=",            # empty: None
    "env.env_id=fake",
    "env.env_id='CarRacing-v3'",
    "env.max_episode_steps=200",
    "runtime.checkpoint_dir=/tmp/some/dir",
    "wm.obs_size=[32, 32]",
    "wm.no_such_key=1",               # KeyError
    "nosection.key=1",                # AttributeError
]


def _outcome(cls, path, overrides):
    try:
        return "ok", cls.from_yaml(path, overrides=overrides).to_dict()
    except Exception as e:  # the type of the error is the result compared
        return "raises", type(e)


def _typed(d):
    """A config dict with each leaf beside its type (1 == 1.0 == True)."""
    if isinstance(d, dict):
        return {k: _typed(v) for k, v in d.items()}
    if isinstance(d, (tuple, list)):
        return type(d), [_typed(v) for v in d]
    return type(d), d


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_overrides_equal_jax(path):
    for ov in OVERRIDES:
        got, want = _outcome(DreamerConfig, path, [ov]), _outcome(JaxConfig, path, [ov])
        assert got[0] == want[0], (ov, got, want)
        if got[0] == "ok":
            assert _typed(got[1]) == _typed(want[1]), ov
        else:
            assert got[1] is want[1], ov


def test_overrides_apply_in_order():
    ovs = ["train.seed=3", "agent.nu=3e-3", "train.seed=4", "env.num_envs=2"]
    path = os.path.join(ROOT, "configs", "fake_smoke.yaml")
    got = DreamerConfig.from_yaml(path, overrides=ovs)
    assert _typed(got.to_dict()) == _typed(JaxConfig.from_yaml(path, overrides=ovs).to_dict())
    assert got.train.seed == 4 and isinstance(got.agent.nu, float)


def test_stable_config_holds_what_its_file_says():
    """configs/car_racer_stable.yaml is the flagship with nu 1e-2, traced_nu
    and analytic_entropy: the port reads exactly those differences."""
    base = DreamerConfig.from_yaml(os.path.join(ROOT, "configs", "car_racer.yaml")).to_dict()
    stable = DreamerConfig.from_yaml(
        os.path.join(ROOT, "configs", "car_racer_stable.yaml")).to_dict()
    diff = {(s, k): (base[s][k], stable[s][k]) for s in base for k in base[s]
            if base[s][k] != stable[s][k]}
    assert diff == {("agent", "nu"): (3e-4, 1e-2), ("agent", "analytic_entropy"): (False, True),
                    ("runtime", "traced_nu"): (False, True)}


FLAT = {
    "hidden_state_dims": 96, "latent_state_dims": [4, 8], "observation_dims": [32, 48],
    "encoder_filter_num_1": 8, "encoder_filter_num_2": 16, "encoder_hidden_layer_nodes": 40,
    "decoder_filter_num_1": 8, "decoder_filter_num_2": 16, "decoder_hidden_layer_nodes": 44,
    "dyn_pred_hidden_num_nodes_1": 20, "dyn_pred_hidden_num_nodes_2": 21,
    "rew_pred_hidden_num_nodes_1": 22, "rew_pred_hidden_num_nodes_2": 23,
    "cont_pred_hidden_num_nodes_1": 24, "cont_pred_hidden_num_nodes_2": 25,
    "critic_reward_buckets": 41, "world_model_lr": 2e-4, "world_model_betas": [0.8, 0.9],
    "world_model_eps": 1e-6, "beta_prediction": 1.5, "beta_dynamics": 0.4,
    "beta_representation": 0.2, "hidden_layer_actor_1_size": 30,
    "hidden_layer_actor_2_size": 31, "hidden_layer_critic_1_size": 32,
    "hidden_layer_critic_2_size": 33, "actor_lr": 1e-5, "actor_betas": [0.7, 0.8],
    "actor_eps": 1e-7, "critic_lr": 3e-5, "critic_betas": [0.6, 0.7], "critic_eps": 1e-8,
    "nu": 0.01, "lambda_": 0.9, "gamma": 0.98, "horizon": 12, "batch_size": 6,
    "sequence_length": 20, "buffer_size": 1000, "training_iterations": 77,
    "random_iterations": 5, "WM_epochs": 3, "AC_epochs": 1, "seed": 9, "env_id": "fake",
    "action_dims": 2, "runtime_compute_dtype": "float32", "runtime_profile": True,
    "an_unused_reference_key": "ignored",
}


def test_from_flat_dict_equals_jax():
    assert DreamerConfig.from_flat_dict(FLAT).to_dict() == JaxConfig.from_flat_dict(FLAT).to_dict()
    assert DreamerConfig.from_flat_dict({}).to_dict() == JaxConfig.from_flat_dict({}).to_dict()


def test_flat_yaml_file_loads_as_jax(tmp_path):
    path = tmp_path / "flat.yaml"
    lines = []
    for k, v in FLAT.items():
        if isinstance(v, list):
            v = "[" + ", ".join(str(x) for x in v) + "]"
        elif isinstance(v, float):
            v = repr(v) if "." in repr(v) else f"{v:.1e}"  # YAML 1.1 floats need a dot
        elif isinstance(v, bool):
            v = str(v).lower()
        lines.append(f"{k}: {v}")
    path.write_text("\n".join(lines) + "\n")
    ovs = ["train.eval_every=5", "agent.nu=3e-3"]
    got = DreamerConfig.from_yaml(str(path), overrides=ovs).to_dict()
    want = JaxConfig.from_yaml(str(path), overrides=ovs).to_dict()
    assert _typed(got) == _typed(want)
    assert got["wm"]["hidden_dim"] == 96 and got["runtime"]["profile"] is True
