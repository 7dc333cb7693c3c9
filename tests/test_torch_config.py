"""The port's config: its YAML reader against PyYAML, and its DreamerConfig
against the JAX package's, on every shipped config file.  Exact equality."""

import glob
import math
import os

import pytest
import yaml

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu_torch.config import DreamerConfig, read_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _ids(paths):
    return [os.path.basename(p) for p in paths]


def test_every_config_is_covered():
    assert len(CONFIGS) >= 7


@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_reader_equals_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_config_equals_jax(path):
    assert DreamerConfig.from_yaml(path).to_dict() == JaxConfig.from_yaml(path).to_dict()


def test_defaults_and_latent_dim_equal_jax():
    assert DreamerConfig().to_dict() == JaxConfig().to_dict()
    assert DreamerConfig().wm.latent_dim == JaxConfig().wm.latent_dim == 32 * 32


_EDGE = """
# leading comment
a:
  sci_string: 1e-3        # YAML 1.1: no dot, so a string
  sci_float: 3.0e-3
  hashed: '#not a comment'   # but this is
  dq: "a \\"quoted\\" # str"
  sq: 'it''s'
  flow: [1, two, 3.5, true, null]
  empty_flow: []
  nothing:
  tilde: ~
  under: 1_000
  neg: -42
  plus: +7
  bools: [yes, No, on, OFF, True]
  inf: -.inf
  nested:
    deeper:
      leaf: 0.5
  after: 1
b: plain words here
c: 0
"""


def test_reader_edge_cases_equal_pyyaml():
    assert read_yaml(_EDGE) == yaml.safe_load(_EDGE)


def test_reader_nan_equals_pyyaml():
    text = "x: .nan\n"
    assert math.isnan(read_yaml(text)["x"]) and math.isnan(yaml.safe_load(text)["x"])


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n",            # block sequence
    "a: {b: 1}\n",            # flow map
    "a: 0x1f\n",              # hex int
    "a: 1:20.5\n",            # base-60 float
    "a:\n  b: 1\n   c: 2\n",  # inconsistent indentation
    "a: 1\na: 2\n",           # duplicate key
    "just a scalar\n",
])
def test_reader_rejects_what_it_does_not_support(text):
    with pytest.raises(ValueError):
        read_yaml(text)


def test_unknown_keys_raise():
    with pytest.raises(KeyError):
        DreamerConfig.from_nested_dict({"wm": {"no_such_field": 1}})
    with pytest.raises(KeyError):
        DreamerConfig.from_nested_dict({"hidden_state_dims": 600})
