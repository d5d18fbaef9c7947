"""Evaluation: conditioned rollout position error, reward accuracy,
long-horizon stability and trivial baselines (counterpart of
`stove_tpu/train/evaluate.py`).

Protocol: condition the posterior on `t_cond` frames, roll the dynamics
forward from the last posterior mean (with the episode's actions), match
predicted slots to ground truth once at the handoff, report per-step
position MSE in [0, 1] image units; for an action-conditioned model also
the predicted rewards' error and ROC-AUC against the true rewards.  Each
function takes a `torch.Generator` for its noise; `noise` (an
`InferNoise`) replaces the posterior's draws, as the parity tests do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stove_tpu_torch.envs.data import Episode, normalize_frames
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.models.dynamics import POS
from stove_tpu_torch.models.stove import InferNoise
from stove_tpu_torch.ops import matching


def _model_pos_to_01(pos: torch.Tensor) -> torch.Tensor:
    """Model/ST [−1, 1] coords → [0, 1] image-normalized coords."""
    return (pos + 1.0) * 0.5


def rollout_metrics(model: StoveModel, ep: Episode,
                    generator: Optional[torch.Generator] = None,
                    t_cond: Optional[int] = None,
                    t_pred: Optional[int] = None,
                    batch: Optional[int] = None,
                    noise: Optional[InferNoise] = None
                    ) -> Dict[str, torch.Tensor]:
    """The paper's eval: per-step position MSE over a prediction rollout."""
    cfg = model.cfg
    t_cond = t_cond or cfg.window
    t_pred = t_pred or cfg.eval_rollout_steps
    if t_cond < 2:
        raise ValueError(f"rollout_metrics needs t_cond >= 2, got {t_cond}")
    B = min(batch or cfg.eval_batch, ep.frames.shape[0])
    frames = normalize_frames(ep.frames[:B, :t_cond])
    actions = ep.actions[:B]

    inf = model.infer(frames, actions[:, :t_cond], noise, generator)
    z_last = inf.z_mean[:, -1]
    roll_actions = actions[:, t_cond - 1: t_cond - 1 + t_pred]
    states, rewards = model.rollout(z_last, roll_actions, t_pred, generator,
                                    sample=False)
    pred = _model_pos_to_01(states[..., POS])                  # (B, T, O, 2)
    last_inferred = _model_pos_to_01(inf.pos_mean[:, -1])      # (B, O, 2)

    true = ep.states[:B, t_cond: t_cond + t_pred, :, :2] / cfg.arena_size
    true_handoff = ep.states[:B, t_cond - 1, :, :2] / cfg.arena_size

    perm = matching.match_positions(last_inferred, true_handoff)  # (B, O)
    idx = perm[:, None, :, None].expand(-1, pred.shape[1], -1, 2)
    pred_matched = torch.gather(pred, 2, idx)

    se = torch.sum((pred_matched - true) ** 2, dim=-1)         # (B, T, O)
    mse_per_step = torch.mean(se, dim=(0, 2))
    true_vel = (ep.states[:B, t_cond - 1, :, :2]
                - ep.states[:B, t_cond - 2, :, :2]) / cfg.arena_size
    pred_vel = matching.apply_permutation(
        inf.z_mean[:, -1, :, 4:6] * 0.5, perm)
    out = {
        "mse_per_step": mse_per_step,
        "mse_mean": torch.mean(mse_per_step),
        "mse_final": mse_per_step[-1],
        "detect_mse": torch.mean(torch.sum(
            (matching.apply_permutation(last_inferred, perm)
             - true_handoff) ** 2, -1)),
        "handoff_vel_rms": torch.sqrt(torch.mean((pred_vel - true_vel) ** 2)),
    }
    if cfg.action_conditioned:
        # the open-loop reward predictions the planner consumes: their
        # error, their AUC, and the AUC at each rollout depth
        true_r = ep.rewards[:B, t_cond - 1: t_cond - 1 + t_pred]
        out["reward_mae"] = torch.mean(torch.abs(rewards - true_r))
        out["reward_auc"] = binary_auc(rewards.reshape(-1),
                                       true_r.reshape(-1))
        out["reward_auc_per_step"] = torch.stack(
            [binary_auc(rewards[:, k], true_r[:, k])
             for k in range(rewards.shape[1])])
    return out


def binary_auc(score: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """ROC-AUC by the Mann-Whitney rank statistic (label 1 = positive;
    evaluate.py:98).  Ties get midranks; NaN when one class is absent.
    Ranks and sums in float64, the result float32."""
    n = score.shape[0]
    order = torch.argsort(score)
    sorted_scores = score[order].contiguous()
    start = torch.searchsorted(sorted_scores, sorted_scores, right=False)
    end = torch.searchsorted(sorted_scores, sorted_scores, right=True)
    mid = 0.5 * (start + 1 + end).to(torch.float64)
    ranks = torch.zeros(n, dtype=torch.float64, device=score.device)
    ranks[order] = mid
    pos = label > 0.5
    n_pos = pos.sum().to(torch.float64)
    n_neg = n - n_pos
    auc = ((torch.sum(torch.where(pos, ranks, 0.0)) - n_pos * (n_pos + 1) / 2)
           / (n_pos * n_neg))
    nan = torch.full_like(auc, float("nan"))
    return torch.where((n_pos > 0) & (n_neg > 0), auc, nan).to(torch.float32)


def baseline_metrics(cfg, ep: Episode, t_cond: Optional[int] = None,
                     t_pred: Optional[int] = None,
                     batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Constant-velocity (`linear`) and repeat-last (`frozen`) rollouts from
    the true handoff state: the floor a trivial predictor reaches."""
    t_cond = t_cond or cfg.window
    t_pred = t_pred or cfg.eval_rollout_steps
    B = min(batch or cfg.eval_batch, ep.frames.shape[0])
    true = ep.states[:B, t_cond: t_cond + t_pred, :, :2] / cfg.arena_size
    p_last = ep.states[:B, t_cond - 1, :, :2] / cfg.arena_size
    v_last = (ep.states[:B, t_cond - 1, :, :2]
              - ep.states[:B, t_cond - 2, :, :2]) / cfg.arena_size
    steps = torch.arange(1, t_pred + 1, dtype=torch.float32,
                         device=true.device)
    linear = p_last[:, None] + steps[None, :, None, None] * v_last[:, None]
    frozen = p_last[:, None].expand(true.shape)
    out = {}
    for name, pred in (("linear", linear), ("frozen", frozen)):
        se = torch.sum((pred - true) ** 2, dim=-1)
        out[f"{name}_mse_per_step"] = torch.mean(se, dim=(0, 2))
        out[f"{name}_mse_final"] = out[f"{name}_mse_per_step"][-1]
    return out


def longhorizon_metrics(model: StoveModel, ep: Episode,
                        generator: Optional[torch.Generator] = None,
                        t_cond: Optional[int] = None, t_pred: int = 50,
                        batch: int = 32, sample: bool = False,
                        noise: Optional[InferNoise] = None
                        ) -> Dict[str, torch.Tensor]:
    """Long-horizon stability: the share of predicted positions inside the
    frame and the ratio of predicted to true mean per-step displacement,
    for the mean rollout or (`sample=True`) the sampled one."""
    cfg = model.cfg
    t_cond = t_cond or cfg.window
    B = min(batch, ep.frames.shape[0])
    t_pred = min(t_pred, ep.frames.shape[1] - t_cond)
    frames = normalize_frames(ep.frames[:B, :t_cond])
    inf = model.infer(frames, ep.actions[:B, :t_cond], noise, generator)
    states, _ = model.rollout(
        inf.z_mean[:, -1], ep.actions[:B, t_cond - 1:t_cond - 1 + t_pred],
        t_pred, generator, sample=sample)
    pred = _model_pos_to_01(states[..., POS])                  # (B, T, O, 2)
    margin = cfg.ball_radius / cfg.arena_size
    in_frame = torch.mean(
        ((pred >= -margin) & (pred <= 1.0 + margin)).to(torch.float32))
    pred_disp = torch.mean(torch.linalg.norm(torch.diff(pred, dim=1),
                                             dim=-1))
    true = ep.states[:B, t_cond:t_cond + t_pred, :, :2] / cfg.arena_size
    true_disp = torch.mean(torch.linalg.norm(torch.diff(true, dim=1),
                                             dim=-1))
    return {
        "horizon": torch.tensor(t_pred),
        "frac_in_frame": in_frame,
        "speed_ratio": pred_disp / (true_disp + 1e-8),
    }
