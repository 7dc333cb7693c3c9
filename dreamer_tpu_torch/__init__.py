"""dreamer_tpu_torch — the PyTorch/CUDA port of dreamer_tpu for one NVIDIA H100.

A second package beside the JAX one, which stays the reference: module names
mirror ``dreamer_tpu`` so that each counterpart is easy to find.  The port
imports torch, numpy and the standard library only; it reads the same
``configs/*.yaml`` with its own small YAML reader.  Every Pallas kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with nvcc on
first use and bound with ctypes (``ops/``), each beside a plain PyTorch
version that the CPU runs.

Ported so far: the serving path, the policy programs of
``dreamer_tpu/train/step.py`` (``train.step.Policy``), with the GRU-cell and
fused conv-encoder kernels; the actor-critic half of the learner
(``train.step.Trainer.ac_step``: replay ring, warm start, imagination through
the whole-rollout kernel, losses and AdamW updates); ``bridge`` moves
parameters and training states from the JAX trees; the world-model half and
with it the whole learner iteration (``Trainer.train_iteration``, through all
four kernels); and the training lifecycle: ``orchestrator.Dreamer``
(kickstart, rollout, eval, checkpoints and resume) with ``envs`` (the fake
env, the env farm), ``utils`` (metrics, checkpoints) and the CLI,
``python -m dreamer_tpu_torch.cli.train``.
"""

__version__ = "0.1.0"

from dreamer_tpu_torch.config import DreamerConfig  # noqa: F401
