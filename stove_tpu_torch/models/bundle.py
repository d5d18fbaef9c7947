"""StoveModel: the public model handle (counterpart of
`stove_tpu/models/bundle.py`).

Holds the config, the parameter tree and the device, and exposes `infer`
and `rollout` as methods.  On a CUDA device the rollout kernel's packed
weights are prepared once here, so every rollout launch reuses them.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.ops import fused_rollout
from stove_tpu_torch.train import checkpoint as ckpt_lib


class StoveModel:
    def __init__(self, cfg: Config, params: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = ckpt_lib.params_from_numpy(params, self.device)
        self.prepared = None
        if self.device.type == "cuda":
            self.prepared = fused_rollout.prepare_params(
                self.params["dynamics"], cfg)

    @classmethod
    def from_run(cls, run_dir: str, cfg: Optional[Config] = None,
                 step: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> "StoveModel":
        """Config (unless given) and latest weights of a JAX run dir."""
        dev = resolve_device(device)
        cfg = cfg if cfg is not None else ckpt_lib.load_config(run_dir)
        return cls(cfg, ckpt_lib.load_params(run_dir, step, dev), dev)

    def infer(self, frames: torch.Tensor,
              actions: Optional[torch.Tensor] = None,
              noise: Optional[stove_lib.InferNoise] = None,
              generator: Optional[torch.Generator] = None
              ) -> stove_lib.InferOut:
        return stove_lib.infer(self.params, self.cfg, frames, actions,
                               noise, generator)

    def rollout(self, z0: torch.Tensor, actions: Optional[torch.Tensor],
                horizon: int, generator: Optional[torch.Generator] = None,
                sample: bool = False):
        return stove_lib.rollout(self.params, self.cfg, z0, actions, horizon,
                                 generator, sample, self.prepared)
