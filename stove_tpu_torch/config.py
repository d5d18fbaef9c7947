"""Flat experiment configuration, shared in shape with the JAX package.

A standalone copy of `stove_tpu/config.py` (the JAX package imports no JAX
there either, but the port depends on nothing of it): the same frozen
dataclass, defaults, presets, `key=value` overrides with type coercion, and
JSON round-trip, so a run directory's `config.json` written by the JAX
trainer loads here unchanged.  `tests/test_torch_config.py` holds the two
copies equal field by field.

Fields that only tune JAX's compilation (`donate_state`, `scan_unroll`,
...) are kept so the JSON round-trip is lossless; the port reads the ones
it implements, the implementation selectors (`spn_impl`, `scan_impl`,
`likelihood_impl`), `fused_epoch` and `mesh_*` among them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


def _coerce(value: str, typ) -> object:
    """Coerce a CLI string to the declared field type (key=value overrides)."""
    if typ in ("bool", bool):
        if isinstance(value, bool):
            return value
        low = str(value).lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if typ in ("int", int):
        return int(value)
    if typ in ("float", float):
        return float(value)
    if typ in ("str", str):
        return str(value)
    # Optional[str] / Optional[int] / tuples
    s = str(typ)
    if "Optional" in s or "None" in s:
        if str(value).lower() in ("none", "null", ""):
            return None
        inner = s.replace("Optional[", "").replace("]", "")
        for cand, t in (("int", int), ("float", float), ("str", str)):
            if cand in inner:
                return t(value)
        return value
    if "Tuple" in s or "tuple" in s:
        parts = [p for p in str(value).replace("(", "").replace(")", "").split(",") if p]
        if "int" in s:
            return tuple(int(p) for p in parts)
        return tuple(float(p) for p in parts)
    return value


@dataclass(frozen=True)
class Config:
    """Every hyperparameter of the framework, in one flat namespace.

    Mirrors the reference's single flat config [ref: model/main.py,
    model/config.py(?)]; key names follow SURVEY.md §5.6 where known.
    """

    # ---- experiment / run management -------------------------------------
    run_name: str = "stove"
    run_dir: str = "runs"
    restore: Optional[str] = None          # run dir to resume from
    seed: int = 0
    nolog: bool = False                    # disable run-dir logging
    debug: bool = False                    # shrink everything for smoke runs
    preset: Optional[str] = None           # name of applied preset, if any

    # ---- task / data ------------------------------------------------------
    task: str = "billiards"                # billiards | gravity | avoidance
    data_dir: str = "data"
    num_obj: int = 3                       # O
    img_size: int = 32                     # square grayscale frames
    channels: int = 1
    seq_len: int = 100                     # frames per generated sequence
    num_train: int = 1000                  # training sequences
    num_test: int = 300                    # test sequences
    # physics (arena is [0, arena_size]^2; SURVEY §2.1: radius ~1.2 in 10x10)
    arena_size: float = 10.0
    ball_radius: float = 1.2
    init_speed: float = 0.5                # per-step speed scale (billiards)
    gravity_strength: float = 0.6          # G in F = G m_i m_j / (r^2 + eps)
    gravity_eps: float = 1.0               # softening epsilon
    gravity_center_pull: float = 0.003     # small centering force (SURVEY §2.1)
    gravity_dt: float = 1.0                # integrator step
    physics_substeps: int = 2              # collision substepping (ours)
    # avoidance task
    num_actions: int = 9                   # 8 compass + no-op
    action_speed: float = 0.6              # controlled-ball speed per action
    reward_contact: float = 0.0            # reward on collision (re-verify 0 vs -1)
    reward_free: float = 1.0               # reward per collision-free step

    # ---- training window / batching --------------------------------------
    window: int = 8                        # T: frames per training window
    batch_size: int = 256
    num_epochs: int = 400
    steps_per_epoch: int = 0               # 0 → max(1, num_train // batch)
    #   (floor; matches Trainer.steps_per_epoch AND the anneal schedule)
    eval_every: int = 1                    # epochs between evals
    ckpt_every: int = 5                    # epochs between checkpoints
    ckpt_keep: int = 3                     # checkpoints retained (pruning);
    #   raise for checkpoint-selection protocols (e.g. gravity stability)
    eval_rollout_steps: int = 8            # prediction horizon for eval MSE
    eval_batch: int = 100                  # sequences used for eval
    eval_longhorizon: int = 0              # >0: every eval also logs mean-
    #   and sampled-rollout stability (frac_in_frame, speed_ratio) at this
    #   horizon, computed on the FIRST half of the test sequences — the
    #   validation half for the pre-registered gravity checkpoint-selection
    #   rule (select on val speed ratio, report on the second half)

    # ---- optimizer --------------------------------------------------------
    supair_lr: float = 2e-3
    dynamics_lr: float = 2e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    grad_clip: float = 10.0
    debug_anneal_lr: float = 0.0           # >0: lr decay to anneal_final;
    #   >1 = absolute steps, (0,1] = fraction of the full training budget.
    #   On by default in presets (1.0): see _PRESET_COMMON.
    #   NOTE (restore compatibility): turning annealing on/off changes the
    #   optax opt_state pytree (schedule-count leaves), so resuming a run
    #   recorded under a different setting requires loading the run dir's
    #   config.json (main.py restore= does this) rather than a fresh preset.
    anneal_shape: str = "linear"           # linear | cosine decay shape
    anneal_final: float = 0.1              # final lr as a fraction of base

    # ---- SuPAIR recognition ----------------------------------------------
    patch_size: int = 10                   # ph = pw (SURVEY: ≈10x10)
    scale_min: float = 0.1                 # min object scale (fraction of img)
    scale_max: float = 0.6                 # max object scale
    encoder_channels: Tuple[int, ...] = (32, 64, 128)
    encoder_mlp_hidden: int = 256
    encoder_space_to_depth: int = 1        # s: fold s×s pixel blocks into
    #   channels before the conv stack (MXU efficiency; 1 = off)
    encoder_final_stride1: bool = False    # last conv at stride 1: keeps a
    #   finer final feature grid (position precision) at slightly more FLOPs
    min_enc_std: float = 0.01              # floor on q_sup stds
    max_enc_std: float = 0.3
    obj_spn_num_sums: int = 10             # RAT-SPN S per region (re-verify)
    obj_spn_num_leaves: int = 10           # RAT-SPN I per leaf region
    obj_spn_depth: int = 2                 # recursive splits
    obj_spn_repetitions: int = 4           # R replicas
    bg_spn_num_sums: int = 6
    bg_spn_num_leaves: int = 6
    bg_spn_depth: int = 3
    bg_spn_repetitions: int = 2
    leaf_min_std: float = 0.08             # Gaussian leaf std floor
    leaf_max_std: float = 1.0
    overlap_correction: bool = True        # marginalize already-claimed pixels
    overlap_impl: str = "patch"            # claim-weight construction:
    #   patch — coverage edges evaluated directly at patch sample coords
    #           (no (B,O,H,W) masks / cummax / second glimpse; fastest)
    #   image — legacy pixel-grid masks + bilinear re-glimpse (round-1
    #           semantics oracle; same math up to mask interpolation)
    supair_only_epochs: int = 2            # SuPAIR warm-up (re-verify length)

    # ---- dynamics / state-space model ------------------------------------
    cl: int = 16                           # unstructured latent width per obj
    dyn_hidden: int = 128                  # graph-net MLP width
    dyn_layers: int = 2                    # hidden layers per MLP core
    action_conditioned: bool = False
    reward_head: bool = True               # only used when action_conditioned
    reward_balanced_loss: bool = True      # inverse-frequency class weights
    reward_pos_rate: float = 0.0           # corpus-level P(reward = 1) used
    #   for the balanced-BCE class weights AND as the planner's calibration
    #   prior.  0 = unset: the Trainer measures it from the training corpus
    #   once at startup and persists it into the run config, so per-batch
    #   estimates (high-variance at realistic collision rates) are never
    #   used at reference scale (VERDICT r2 weak #5).  -1 = force the
    #   legacy per-batch estimate with calibration off (A/B control)
    reward_label_smooth: float = 0.0       # BCE label smoothing s:
    #   targets t → t(1−s)+s/2. Keeps the head's probabilities graded —
    #   near-binary predictions make MCTS branch values flip on small
    #   open-loop errors (planning anti-correlates with head sharpness)
    min_dyn_std: float = 0.01
    max_dyn_std: float = 0.3
    latent_residual: bool = True           # ℓ_t = ℓ_{t-1} + Δℓ vs direct
    velocity_posterior: bool = True        # build q(v) from position diffs
    velocity_obs_full_std: bool = True     # q(v) obs std: propagate both
    #   frames' encoder position stds (sqrt(ss_t² + ss_{t−1}²)); False keeps
    #   the t-frame std only (round-1 behavior; A/B'd in RESULTS.md)
    velocity_obs: str = "encoder"          # q(v)'s observation source:
    #   encoder  — difference of raw encoder position means (original)
    #   filtered — difference of the POSTERIOR position means.  At handoff
    #              the filtered velocity is more accurate (0.0117 vs 0.0169
    #              rms) but END-TO-END it is mse@8-NEUTRAL (RESULTS.md
    #              "velocity-posterior study": the dynamics net absorbs the
    #              handoff noise either way) — kept as an option, not a win
    size_std: float = 0.01                 # carried-size transition std
    overshoot_k: int = 0                   # latent overshooting horizon (0=off)
    overshoot_weight: float = 1.0          # weight of the k-step position loss
    overshoot_sample: bool = False         # roll the overshoot open loop on
    #   sampled transitions (σ stop-gradded): noise-robustness training for
    #   long sampled rollouts (gravity energy faithfulness)
    reward_overshoot_weight: float = 1.0   # weight of open-loop reward BCE
    #   (active when overshoot_k > 0 and the reward head is on; trains the
    #   reward head on the same open-loop distribution MCTS consumes)
    open_loop_sigma: bool = False          # learn a second transition std
    #   for OPEN-LOOP rollouts (process noise), separate from the filter
    #   std that must cover posterior-sample jitter in the ELBO.  Trained
    #   on 1-step open-loop NLL against posterior MEANS (inside the
    #   overshoot machinery); consumed by rollout(sample=True).  Fixes the
    #   ~2x energy inflation of sampled long-horizon rollouts (VERDICT r2
    #   missing #4).  Requires overshoot_k >= 1.
    open_loop_sigma_weight: float = 1.0    # weight of the sigma-open NLL
    open_loop_sigma_horizons: Tuple[int, ...] = (1,)  # horizons k of
    #   the open-loop sigma NLL: posterior means at t+k are scored under
    #   N(mean-rollout_k, sqrt(Σ_j σ_open,j²)) — the accumulated variance a
    #   sampled rollout would actually inject over k steps.  The round-3
    #   1-step-only fit (≡ horizons=(1,)) bakes the model's systematic
    #   1-step bias + posterior-mean target noise into σ, which a sampled
    #   rollout then RE-injects as fresh iid noise every step — measured
    #   1.9–3.2× energy over-injection on 2/4 gravity seeds, patched by a
    #   hand-swept rollout_sigma_temp (round-3 caveat).  Round 4 shipped
    #   (1, 4, 8) as the default on the theory that fitting σ at the
    #   evaluation dispersion closes the gap; the round-5 validating
    #   retrains (criterion 3: 5 gravity protocol runs under (1,4,8))
    #   measured raw temp=1 sampled 80-step speed ratios 2.1–5.4 — ALL
    #   above the pre-registered ≤1.3 bar — so the default reverted to
    #   (1,) and the val-calibrated rollout_sigma_temp stays the recipe
    #   (calibrated ratios on the same models: 1.08–1.28).  Multi-horizon
    #   fitting remains available as an override.  Horizons > window−2
    #   are dropped.
    min_open_std: float = 0.001            # floor for the open-loop std —
    #   deliberately below min_dyn_std: true process noise of the (nearly
    #   deterministic) physics is far smaller than posterior jitter
    rollout_sigma_temp: float = 1.0        # multiplies the std used by
    #   rollout(sample=True).  The 1-step open-loop NLL sigma includes the
    #   model's systematic 1-step bias, which compounds coherently over a
    #   long horizon rather than as iid noise — a validation-calibrated
    #   temp < 1 corrects the resulting energy inflation (round-3 gravity
    #   protocol; see scripts/grav_select.py)

    # ---- parallelism / performance ---------------------------------------
    mesh_shape: Tuple[int, ...] = (0,)     # (0,) → all local devices on 'data'
    mesh_axes: Tuple[str, ...] = ("data",)
    spn_impl: str = "dense"                # SPN evaluation path:
    #   dense  — layerwise einsum stack (golden-oracle shape; fastest once
    #            the patch-space overlap correction removed the mask
    #            tensors: 67.5k vs 58.4k windows/s at B=1024, measured
    #            interleaved best-of-3)
    #   matmul — leaf stage folded into 3 MXU matmuls (no (B,R,V,I)
    #            intermediates; was fastest in the round-2 first pass)
    #   pallas — fused VMEM-resident kernel (forward; XLA-dense backward);
    #            falls back to matmul where Mosaic can't run (logged once)
    scan_impl: str = "xla"                 # phase-2 posterior recursion:
    #   xla    — lax.scan of per-step ops (reference semantics)
    #   pallas — whole-window fused kernel forward (ops/pallas_scan.py;
    #            state + weights VMEM-resident, pre-drawn threefry ε so
    #            sampling stays bit-deterministic) with the XLA scan as
    #            the custom-VJP backward
    likelihood_impl: str = "xla"           # SuPAIR likelihood path:
    #   xla    — glimpse einsums + overlap chain + SPN stages (the SPN
    #            stage itself still honors spn_impl)
    #   pallas — whole likelihood fused per batch tile (frames → summed
    #            root log-density, ops/pallas_likelihood.py; XLA-dense
    #            custom-VJP backward).  Requires overlap_impl='patch'.
    fused_epoch: bool = True               # scan whole epoch in one jit call
    compute_dtype: str = "float32"         # bfloat16 | float32 for nets
    donate_state: bool = True
    scan_unroll: int = 1                   # unroll factor for the posterior
    #   scan (T−2 steps of tiny latency-bound ops; unrolling lets XLA fuse
    #   across steps and drop loop bookkeeping)

    # ---- planning (MCTS) --------------------------------------------------
    mcts_simulations: int = 100
    mcts_horizon: int = 10
    mcts_c_uct: float = 1.0
    mcts_discount: float = 0.95
    mcts_episodes: int = 10
    mcts_episode_len: int = 100
    mcts_frontier: int = 4                 # leaves expanded per device call
    #   (1 = serial UCT like the reference; >1 batches K·A evals per call)
    mcts_eval_samples: int = 1             # rollouts averaged per leaf eval
    #   (1 = one mean rollout; >1 = that many SAMPLED rollouts, averaged —
    #   integrates transition noise into the value estimate)
    mcts_reward_base_rate: float = 0.0     # π = P(reward=1) in the training
    #   corpus; >0 undoes the balanced-BCE probability distortion in the
    #   planner's value estimates (calibration; 0 = off)
    mcts_virtual_loss: float = 1.0         # selection diversification weight
    mcts_rollout_impl: str = "xla"         # leaf-evaluation rollout path:
    #   xla    — jitted lax.scan (serial-identical keys; the default)
    #   pallas — fused whole-horizon kernel (ops/pallas_rollout.rollout_act):
    #            action sequences still drawn from the same per-episode
    #            keys, but sampled-leaf noise comes from the kernel PRNG,
    #            so scores are CRN-comparable, not bit-identical
    mcts_lockstep: bool = True             # run all evaluation episodes'
    #   searches in lockstep: E trees advance together, merging their K·A
    #   frontier evaluations into one (E·K·A)-batch device call per round
    #   (per-episode results match the serial path with the same keys;
    #   measured ~19x faster on the 40-episode CRN eval)
    mcts_reward_temp: float = 1.0          # >1: soften reward probabilities
    #   (sigmoid(logit(p)/T)) in the planner's value estimates — a sharp
    #   head's near-binary predictions make branch values flip on small
    #   open-loop errors; smoothing grades them by collision risk
    mcts_depth_shrink: float = 1.0         # λ ∈ (0, 1]: shrink step-t leaf
    #   reward predictions toward the base rate π by λ^(t+1).  Counters the
    #   measured depth-rot of open-loop reward AUC (0.96 → 0.78 over 8
    #   steps, runs/plan_branch_diag_*.json): deep search argmaxes over
    #   thousands of depth-6..8 leaf estimates whose discrimination has
    #   decayed, a Goodhart surface; shrinkage discounts exactly the
    #   unreliable depths.  1.0 = off.
    mcts_shrink_mode: str = "leaf"         # what "depth" means for the λ^d
    #   shrink exponent:
    #   leaf — restart at every leaf evaluation (step t of the rollout gets
    #          λ^(t+1) regardless of where the leaf sits in the tree); tree-
    #          edge step rewards are never shrunk
    #   tree — track TOTAL open-loop depth from the root observation: a
    #          rollout step t from a node at tree depth d gets λ^(d+t+1) and
    #          the edge reward into depth d gets λ^d.  The AUC rot the shrink
    #          counters compounds from the root (position error accumulates
    #          across the whole model rollout), so leaf mode under-shrinks
    #          deep tree branches and over-shrinks the root frontier; tree
    #          mode matches the measured rot profile.  With depth 0 the two
    #          modes coincide (tested).

    # ------------------------------------------------------------------ api
    def with_overrides(self, *kv: str, **kwargs) -> "Config":
        """Apply `key=value` strings (CLI style) and/or keyword overrides."""
        updates = {}
        fields = {f.name: f for f in dataclasses.fields(self)}
        for item in kv:
            if "=" not in item:
                raise ValueError(f"override {item!r} is not key=value")
            key, _, val = item.partition("=")
            key = key.strip()
            if key not in fields:
                raise KeyError(f"unknown config key {key!r}")
            updates[key] = _coerce(val.strip(), fields[key].type)
        for key, val in kwargs.items():
            if key not in fields:
                raise KeyError(f"unknown config key {key!r}")
            updates[key] = val
        return dataclasses.replace(self, **updates)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        clean = {}
        for key, val in raw.items():
            if key not in fields:
                continue  # forward compatibility
            if isinstance(val, list):
                val = tuple(val)
            clean[key] = val
        return cls(**clean)

    # convenience geometry ---------------------------------------------------
    @property
    def state_dim(self) -> int:
        """Structured state dim per object: size(2) + pos(2) + velo(2)."""
        return 6

    @property
    def full_state_dim(self) -> int:
        return self.state_dim + self.cl

    def debug_shrunk(self) -> "Config":
        """Tiny everything, for smoke tests (reference `debug_*` flags)."""
        return self.with_overrides(
            debug=True, num_train=8, num_test=4, seq_len=20, batch_size=4,
            num_epochs=2, eval_batch=2, encoder_channels=(8, 16),
            encoder_mlp_hidden=32, obj_spn_num_sums=3, obj_spn_num_leaves=3,
            obj_spn_repetitions=2, obj_spn_depth=1, bg_spn_num_sums=2,
            bg_spn_num_leaves=2, bg_spn_depth=2, bg_spn_repetitions=1,
            dyn_hidden=32, cl=4, mcts_simulations=8, mcts_horizon=4,
            supair_only_epochs=1,
        )


# Settings shared by every preset (round-2 validated improvements over the
# bare-Config defaults; the bare defaults stay backward-compatible so run
# dirs written before these fields existed restore correctly).
_PRESET_COMMON = dict(
    # s=2 space-to-depth encoder: +20% train throughput; accuracy-neutral
    # within measured seed noise (RESULTS.md round-2 audit)
    encoder_space_to_depth=2,
    # linear LR decay to 10% over the whole run: moves 360-epoch billiards
    # mse@8 from the ~0.041 plateau to 0.0097 (chain 10) — annealing
    # reliably reaches the precise-dynamics basin that constant-lr runs
    # only hit on lucky seeds
    debug_anneal_lr=1.0,
)

# The five configs from BASELINE.json, as named presets.
PRESETS = {
    # 1. SuPAIR-only object detection ELBO on 2-ball billiards frames
    "supair_billiards2": dict(task="billiards", num_obj=2, run_name="supair2",
                              reward_head=False),
    # 2. STOVE video prediction, 3-ball billiards
    "stove_billiards": dict(task="billiards", num_obj=3, run_name="stove_bil",
                            reward_head=False, overshoot_k=4,
                            overshoot_weight=100.0),
    # 3. STOVE on gravity (long-horizon rollout stability)
    "stove_gravity": dict(task="gravity", num_obj=3, run_name="stove_grav",
                          init_speed=0.0, reward_head=False, overshoot_k=4,
                          overshoot_weight=100.0),
    # 4. action-conditioned STOVE on avoidance (reward head)
    "stove_avoidance": dict(task="avoidance", num_obj=3, run_name="stove_avoid",
                            action_conditioned=True, reward_head=True,
                            overshoot_k=4, overshoot_weight=100.0),
    # 5. MCTS planning in avoidance env using jitted model rollouts.
    #    Encodes the measured-best round-3 recipe (RESULTS.md fine-λ table,
    #    80 episodes: 864 simulations at λ∈[0.55, 0.65] is the optimum —
    #    more search re-Goodharts, λ=1 leaves ~0.8 reward on the table; at
    #    the reference-scale 54-sim budget the shrink is near-neutral).
    "mcts_avoidance": dict(task="avoidance", num_obj=3, run_name="mcts_avoid",
                           action_conditioned=True, reward_head=True,
                           mcts_simulations=864, mcts_depth_shrink=0.55),
    # denser variant: collisions frequent enough that a random policy fails
    # visibly — the planning benchmark environment (paper-style difficulty)
    "avoidance_dense": dict(task="avoidance", num_obj=3, run_name="avoid_dense",
                            action_conditioned=True, reward_head=True,
                            ball_radius=1.6, init_speed=0.8,
                            action_speed=0.7, overshoot_k=4,
                            overshoot_weight=100.0),
}


def make_config(preset: Optional[str] = None, *overrides: str, **kwargs) -> Config:
    cfg = Config()
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        cfg = cfg.with_overrides(**{**_PRESET_COMMON, **PRESETS[preset]})
        cfg = dataclasses.replace(cfg, preset=preset)
    return cfg.with_overrides(*overrides, **kwargs)
