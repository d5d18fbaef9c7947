"""stove_tpu_torch — the PyTorch/CUDA port of `stove_tpu`.

The layout mirrors the JAX package module for module, so each counterpart
is found under the same name:

  envs/      billiards, gravity and avoidance physics, corpora and their
             files, window batches
  models/    encoder, SuPAIR (SPN likelihood), RAT-SPN, graph-net dynamics,
             STOVE (inference, ELBO, rollout)
  ops/       Gaussian algebra, glimpses, matching, the kernel wrappers
             (rollout, posterior scan, SPN, likelihood) and their builder
  planning/  MCTS from pixels with a learned or an oracle simulator
  train/     checkpoints in the JAX npz layout, trainer, metrics,
             evaluation, GIF and PNG dumps
  utils/     torch.profiler traces
  tools/     measurement scripts run on the card
  csrc/      hand-written CUDA C++ kernels, built with nvcc at first use
  compat.py  the reference's stateful envs and `generate_data`
  main.py    `python -m stove_tpu_torch.main [mode=train|eval|mcts|
             generate|viz|profile] ...`

The port imports torch, numpy and the standard library only.  Parameters
are plain nested dicts/lists of tensors with the JAX package's key names
and (in, out) weight layout, so a JAX checkpoint maps onto them 1:1.
Entry points take an explicit `device`; they default to CUDA and raise
when no card is present rather than running on the CPU.
"""

__version__ = "0.1.0"

from stove_tpu_torch.config import Config, PRESETS, make_config  # noqa: F401
from stove_tpu_torch.device import resolve_device  # noqa: F401
