"""StoveModel: the public model handle (counterpart of
`stove_tpu/models/bundle.py`).

Holds the config, the RAT-SPN region graphs (`specs`, from the run's
permutation seeds), the parameter tree and the device, and exposes
`init_params`, `elbo`, `supair_elbo`, `infer`, `infer_each` and
`rollout`.  On a CUDA device the rollout kernel's packed weights are
prepared from `params` at the first rollout (again after `set_params`),
so every rollout launch reuses them; a model the kernel does not take (a
debug-width config) trains on the card without them.
`cfg.compute_dtype` sets the precision of the encoder, the dynamics and
the rollout (`dynamics.precision_of`); parameters stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.models import supair as supair_lib
from stove_tpu_torch.ops import fused_rollout
from stove_tpu_torch.train import checkpoint as ckpt_lib


class StoveModel:
    def __init__(self, cfg: Config, params: Optional[Dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seeds: Optional[supair_lib.SpecSeeds] = None):
        """`seeds`: the SPN permutation seeds (a fresh draw from cfg.seed
        when absent); `params`: the weights (a fresh `init_params` when
        absent)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seeds = seeds if seeds is not None else \
            supair_lib.draw_spec_seeds(cfg)
        self.specs = stove_lib.make_specs(cfg, self.seeds)
        self.set_params(self.init_params() if params is None else params)

    @classmethod
    def from_run(cls, run_dir: str, cfg: Optional[Config] = None,
                 step: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> "StoveModel":
        """Config (unless given), SPN seeds and latest weights of a run
        directory written by the JAX trainer or the port's."""
        dev = resolve_device(device)
        cfg = cfg if cfg is not None else ckpt_lib.load_config(run_dir)
        return cls(cfg, ckpt_lib.load_params(run_dir, step, dev), dev,
                   supair_lib.run_spec_seeds(run_dir, cfg))

    def set_params(self, params: Dict) -> None:
        """Use `params` (moved to the model's device as needed); the rollout
        kernel's packed weights are packed from them anew at first use."""
        self.params = ckpt_lib.params_from_numpy(params, self.device)
        self._prepared: Dict[bool, torch.Tensor] = {}
        self.precision = dyn_lib.precision_of(self.cfg)

    @property
    def prepared(self) -> Optional[torch.Tensor]:
        """The packed weights at compute_dtype's precision (`prepared_for`)."""
        return self.prepared_for(self.precision)

    def prepared_for(self, dtype: str) -> Optional[torch.Tensor]:
        """The rollout kernel's packed weights for `dtype` on the card,
        packed once per set of params (one buffer serves both bf16
        precisions); None on the CPU."""
        if self.device.type != "cuda":
            return None
        key = fused_rollout.check_dtype(dtype) != "float32"
        if key not in self._prepared:
            with torch.no_grad():
                self._prepared[key] = fused_rollout.prepare_params(
                    self.params["dynamics"], self.cfg, dtype)
        return self._prepared[key]

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict:
        """Fresh weights, drawn from `generator` (default: one seeded with
        cfg.seed + 1, as the reference seeds its init key)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed + 1)
        return stove_lib.init_params(self.cfg, self.specs, generator,
                                     self.device)

    def elbo(self, params: Dict, frames: torch.Tensor,
             actions: Optional[torch.Tensor] = None,
             rewards: Optional[torch.Tensor] = None,
             noise: Optional[stove_lib.ElboNoise] = None,
             generator: Optional[torch.Generator] = None,
             batch_rewards: Optional[torch.Tensor] = None
             ) -> stove_lib.ElboOut:
        return stove_lib.elbo(params, self.cfg, self.specs, frames, actions,
                              rewards, noise, generator, batch_rewards)

    def supair_elbo(self, params: Dict, frames: torch.Tensor,
                    noise: torch.Tensor):
        return supair_lib.elbo(params["supair"], self.cfg, self.specs.supair,
                               frames, noise)

    def infer(self, frames: torch.Tensor,
              actions: Optional[torch.Tensor] = None,
              noise: Optional[stove_lib.InferNoise] = None,
              generator: Optional[torch.Generator] = None
              ) -> stove_lib.InferOut:
        return stove_lib.infer(self.params, self.cfg, frames, actions,
                               noise, generator)

    def infer_each(self, frames: torch.Tensor,
                   actions: Optional[torch.Tensor],
                   generators: Sequence[torch.Generator]
                   ) -> stove_lib.InferOut:
        """Per-episode posteriors in one batched call (bundle.py:58):
        frames (E, B, T, H, W), actions (E, B, T) or None, one generator
        per episode.  Episode e's noise is drawn from generators[e] exactly
        as `infer` draws it for a (B, T) window, so its rows equal an
        `infer` call on that episode alone; every output gains a leading
        episode axis."""
        E, B, T = frames.shape[:3]
        if len(generators) != E:
            raise ValueError(f"{len(generators)} generators for {E} episodes")
        noises = [stove_lib.draw_infer_noise(self.cfg, B, T, g, frames.device)
                  for g in generators]
        noise = stove_lib.InferNoise(*(torch.cat(parts, 0)
                                       for parts in zip(*noises)))
        flat = self.infer(frames.reshape(E * B, *frames.shape[2:]),
                          None if actions is None
                          else actions.reshape(E * B, T), noise)
        return stove_lib.InferOut(*(x.reshape(E, B, *x.shape[1:])
                                    for x in flat))

    def rollout(self, z0: torch.Tensor, actions: Optional[torch.Tensor],
                horizon: int, generator: Optional[torch.Generator] = None,
                sample: bool = False, dtype: Optional[str] = None):
        """`stove.rollout` with this model's weights; `dtype` the
        precision (`dynamics.PRECISIONS`; None: compute_dtype's)."""
        dtype = dtype or self.precision
        return stove_lib.rollout(self.params, self.cfg, z0, actions, horizon,
                                 generator, sample, self.prepared_for(dtype),
                                 dtype)
