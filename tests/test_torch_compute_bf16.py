"""compute_dtype=bfloat16 of the port on the CPU, against the JAX package
at compute_dtype=bfloat16: the operands of the encoder's convolutions and
dense layers and of every dynamics product rounded to bfloat16, sums in
float32 (stove_tpu/models/encoder.py:71-99, dynamics.py:61-68, :120).

Each bf16 result is held by `bf16_parity.hold_bf16` (tests/
test_torch_rollout_bf16.py explains it): the port's distance from JAX's
bf16 result at most 0.1x the distance between JAX's bf16 and f32 results
in the medians, a flipped rounding told from a fault by the maxima and the
share of moved entries.  On the CPU the port's plain versions round at the
same points as JAX's dense path, so the distance is mostly 0 (single
roundings flip where two f32 sums of the same bf16 products are taken in
another order).

Also here: the TPU kernel's bf16 variant (dtype "bfloat16", what
`scan_impl=pallas` and the `pallas` planner leaves run) is not what
compute_dtype=bfloat16 dispatches to, and it computes another function
(the guard); the `scan_impl=pallas` gradient is the VJP of the plain scan
at compute_dtype; the planner's leaf precision; the CLI's train and eval
at bf16.  The ELBO and the eval bands are in
tests/test_torch_compute_bf16_elbo.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import dynamics as jdyn
from stove_tpu.models import encoder as jenc
from stove_tpu.models import stove as jstove
from stove_tpu_torch import main as tmain
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models import encoder as tenc
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan
from stove_tpu_torch.planning import simulators as sims
from stove_tpu_torch.train import checkpoint as ckpt
from bf16_parity import REWARDS, hold_bf16
from torch_parity import to_jax

BILL, AVOID, GRAV = ("ckpts/r4rp_bill_s32", "ckpts/r4a_dense_s2",
                     "ckpts/r4rp_grav_s32")
RUNS = {"billiards": BILL, "avoidance": AVOID, "gravity": GRAV}
STEPS = 4
BF16 = dict(compute_dtype="bfloat16")
F32 = dict(compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))


def _z0(cfg, B, seed):
    rng = np.random.default_rng(seed)
    O, D = cfg.num_obj, cfg.full_state_dim
    z = np.zeros((B, O, D), np.float32)
    z[..., 0:2] = 0.24
    z[..., 2:4] = rng.uniform(-0.7, 0.7, (B, O, 2))
    z[..., 4:6] = rng.normal(0.0, 0.05, (B, O, 2))
    z[..., 6:] = rng.normal(0.0, 0.5, (B, O, cfg.cl))
    return z


def _trained(name):
    """The run's bf16 config, dynamics weights and JAX config."""
    cfg = ckpt.load_config(RUNS[name]).with_overrides(**BF16)
    dyn = ckpt.load_params(RUNS[name], device="cpu")["dynamics"]
    return cfg, dyn, JConfig.from_json(cfg.to_json())


def _actions(cfg, B, steps, seed):
    if not cfg.action_conditioned:
        return None
    return np.random.default_rng(seed).integers(
        0, cfg.num_actions, (B, steps)).astype(np.int32)


# ------------------------------------------------------------ the modules

@pytest.mark.parametrize("s2d", [1, 2], ids=["plain", "space-to-depth"])
def test_encoder_matches_jax_bf16(s2d):
    """encoder.apply at bf16 against JAX's on full-width random weights,
    8 frames: per frame (the "step" axis) held by hold_bf16; the CPU
    convolutions agree bit for bit but for single flipped roundings (the
    sums of the rounded products in another order)."""
    jc = JConfig().with_overrides(encoder_space_to_depth=s2d, **BF16)
    tc = Config.from_json(jc.to_json())
    jp = jenc.init_params(jax.random.key(s2d), jc)
    tp = jax.tree_util.tree_map(_t, jp)
    frames = np.random.default_rng(s2d).uniform(
        size=(8, jc.img_size, jc.img_size)).astype(np.float32)
    want = jenc.apply(jp, jc, jnp.asarray(frames))
    f32 = jenc.apply(jp, jc.with_overrides(**F32), jnp.asarray(frames))
    got = tenc.apply(tp, tc, _t(frames))
    for i, name in enumerate(("mean", "std")):
        assert got[i].dtype == torch.float32
        hold_bf16(f"encoder {name}", got[i], want[i], f32[i], steps=8,
                  axis=0)
    exact = np.mean(got[0].numpy() == np.asarray(want[0]))
    assert exact > 0.4, exact


@pytest.mark.parametrize("name", list(RUNS))
def test_dynamics_apply_matches_jax_bf16(name):
    """One `dynamics.apply` step at compute_dtype=bfloat16 (the default
    precision it reads from the config) against JAX's, B=16 on the trained
    weights: the mean and the rewards (avoidance's reward head) by
    hold_bf16; the stds (gravity's open-loop head too) within 0.1x of the
    largest bf16 - f32 distance."""
    cfg, dyn, jc = _trained(name)
    z0 = _z0(cfg, 16, 3)
    acts = _actions(cfg, 16, 1, 4)
    a_j = None if acts is None else jnp.asarray(acts[:, 0])
    a_t = None if acts is None else _t(acts[:, 0]).long()
    jp = to_jax(dyn)
    apply = jax.jit(jdyn.apply, static_argnums=1)
    want = apply(jp, jc, jnp.asarray(z0), a_j)
    f32 = apply(jp, jc.with_overrides(**F32), jnp.asarray(z0), a_j)
    got = dyn_lib.apply(dyn, cfg, _t(z0), a_t)
    hold_bf16(f"{name} mean", got.mean[None], want.mean[None],
              f32.mean[None], steps=1, axis=0)
    if cfg.reward_head:
        hold_bf16(f"{name} reward", got.reward[None], want.reward[None],
                  f32.reward[None], steps=1, axis=0, **REWARDS)
    for field in ("std", "std_open"):
        g, w, f = (np.asarray(getattr(x, field)) for x in (got, want, f32))
        assert np.abs(w - f).max() > 0, field
        assert np.abs(g - w).max() <= 0.1 * np.abs(w - f).max(), field


def _jax_rollouts(jc, dyn, z0, acts):
    roll = jax.jit(lambda p, c, z, a: jstove.rollout(
        p, c, z, a, STEPS, jax.random.key(0)), static_argnums=1)
    a = None if acts is None else jnp.asarray(acts)
    return (roll({"dynamics": to_jax(dyn)}, c, jnp.asarray(z0), a)
            for c in (jc, jc.with_overrides(**F32)))


@pytest.mark.parametrize("name", list(RUNS))
def test_dense_bf16_rollout_matches_jax_bf16(name):
    """The rollout's plain version at "dense_bf16" (the precision
    compute_dtype=bfloat16 asks for) against JAX's `stove.rollout` at
    compute_dtype=bfloat16: mean, 4 steps, B=16, states and rewards."""
    cfg, dyn, jc = _trained(name)
    z0, acts = _z0(cfg, 16, 3), _actions(cfg, 16, STEPS, 4)
    (js, jr), (fs, fr32) = _jax_rollouts(jc, dyn, z0, acts)
    ps, prew = fr.rollout_states_reference(
        dyn, cfg, _t(z0), STEPS, None,
        None if acts is None else _t(acts).long())
    hold_bf16(f"{name} states", ps, js, fs)
    if cfg.reward_head:
        hold_bf16(f"{name} rewards", prew, jr, fr32, **REWARDS)
    assert fr.launch_kernel.launches == 0


def test_the_kernel_variant_is_not_compute_dtype_bf16(monkeypatch):
    """The guard.  compute_dtype=bfloat16 dispatches the rollout at
    "dense_bf16" (its own library, -DSTOVE_BF16=2), never at the TPU
    kernel's "bfloat16" variant (-DSTOVE_BF16=1), and that variant
    computes another function: it keeps the attention column and the
    reward head's geometry rows and last layers in f32, and its distance
    from JAX's dense bf16 path fails hold_bf16 (ratio of the medians
    0.11-0.25 at step 1, 0.70-0.90 at step 4 on these inputs)."""
    cfg, dyn, jc = _trained("avoidance")
    model = StoveModel(cfg, {"dynamics": dyn, "supair": ckpt.load_params(
        AVOID, device="cpu")["supair"]}, device="cpu",
        seeds=tsup.run_spec_seeds(AVOID, cfg))
    assert model.precision == "dense_bf16"
    seen = []
    real = fr.rollout

    def spy(*args, **kw):
        seen.append(kw.get("dtype", args[-1] if len(args) > 8 else None))
        return real(*args, **kw)

    monkeypatch.setattr(fr, "rollout", spy)
    z0, acts = _z0(cfg, 16, 3), _actions(cfg, 16, STEPS, 4)
    model.rollout(_t(z0), _t(acts).long(), STEPS)
    assert seen == ["dense_bf16"]
    dense, kern = (fr.job(cfg, False, d, 4)[1] for d in ("dense_bf16",
                                                         "bfloat16"))
    assert "-DSTOVE_BF16=2" in dense and "-DSTOVE_BF16=1" in kern
    assert fr.kernel_bytes(cfg, False, "dense_bf16") == fr.kernel_bytes(
        cfg, False, "bfloat16")
    (js, jr), (fs, _) = _jax_rollouts(jc, dyn, z0, acts)
    ks, _ = fr.rollout_states_reference(dyn, cfg, _t(z0), STEPS, None,
                                        _t(acts).long(), "bfloat16")
    with pytest.raises(AssertionError):
        hold_bf16("kernel variant vs dense bf16", ks, js, fs)


def _scan_inputs(cfg, B, T2, seed):
    rng = np.random.default_rng(seed)
    O, D, f32 = cfg.num_obj, cfg.full_state_dim, np.float32
    return [_z0(cfg, B, seed + 1),
            rng.normal(0, 0.3, (B, O, 2)).astype(f32),
            (0.05 + 0.1 * rng.uniform(size=(B, O, 2))).astype(f32),
            rng.normal(0, 0.3, (B, T2, O, 4)).astype(f32),
            (0.05 + 0.1 * rng.uniform(size=(B, T2, O, 4))).astype(f32),
            rng.integers(0, max(cfg.num_actions, 1), (B, T2)).astype(
                np.int32),
            rng.normal(size=(B, T2, O, D)).astype(f32)]


def _torch_scan_inputs(args):
    t = [_t(a) for a in args]
    t[5] = t[5].long()
    return t


@pytest.mark.parametrize("name", ["billiards", "avoidance"])
def test_scan_reference_matches_jax_scan_xla_bf16(name):
    """`scan_reference` at its default precision under compute_dtype=
    bfloat16 against JAX's `_scan_xla` at bf16, B=8, T2=4: z, z_mean and
    the rewards by step, kl within 0.1x of the largest bf16 - f32
    distance."""
    cfg, dyn, jc = _trained(name)
    args = _scan_inputs(cfg, 8, STEPS, 7)
    scan = jax.jit(jstove._scan_xla, static_argnums=1)
    want = scan(to_jax(dyn), jc, *map(jnp.asarray, args))
    f32 = scan(to_jax(dyn), jc.with_overrides(**F32),
               *map(jnp.asarray, args))
    got = fused_scan.scan_reference(dyn, cfg, *_torch_scan_inputs(args))
    for i, field in ((0, "z"), (1, "z_mean"), (3, "rewards")):
        if field == "rewards" and not cfg.reward_head:
            continue
        hold_bf16(f"{name} scan {field}", got[i], want[i], f32[i],
                  **(REWARDS if i == 3 else {}))
    kb, kf = np.asarray(want[2]), np.asarray(f32[2])
    assert np.abs(got[2].numpy() - kb).max() <= 0.1 * np.abs(kb - kf).max()


def test_scan_pallas_gradient_is_the_bf16_plain_vjp():
    """scan_impl=pallas under compute_dtype=bfloat16: the forward is the
    kernel's bf16 variant (its plain version on the CPU) and the gradient
    the VJP of the plain scan at compute_dtype's precision, "dense_bf16"
    (as `_scan_pallas_bwd` differentiates `_scan_xla` at cfg), not the
    float32 one's."""
    cfg, dyn, _ = _trained("avoidance")
    ins = _torch_scan_inputs(_scan_inputs(cfg, 4, 3, 9))
    cot = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
           for i, x in enumerate(fused_scan.scan_reference(dyn, cfg, *ins))]

    def grads(fn, **kw):
        lv = [x.clone().requires_grad_(True) for x in tree.leaves(dyn)]
        out = fn(tree.unflatten(dyn, lv), cfg, *ins, **kw)
        torch.autograd.backward([out[0], out[1], out[2], out[3]], cot)
        return out, [x.grad for x in lv]

    out, g = grads(fused_scan.scan_fused)
    for a, b in zip(out, fused_scan.scan_reference(dyn, cfg, *ins,
                                                   dtype="bfloat16")):
        assert torch.equal(a.detach(), b)
    _, g_dense = grads(fused_scan.scan_reference)
    _, g_f32 = grads(fused_scan.scan_reference, dtype="float32")
    for a, b in zip(g, g_dense):
        assert torch.equal(a, b)
    assert max(float((a - b).abs().max()) for a, b in zip(g, g_f32)) > 1e-4


# ------------------------------------------------------------ the paths

@pytest.mark.parametrize("impl,leaf", [("xla", "dense_bf16"),
                                       ("pallas", "bfloat16")])
def test_planner_leaf_precision_at_bf16(impl, leaf, monkeypatch):
    """Under compute_dtype=bfloat16 the planner's `xla` leaves and its
    step run at "dense_bf16" (stove.rollout at compute_dtype, as the JAX
    planner's rollout_raw), its `pallas` leaves at the TPU kernel's
    "bfloat16" variant (simulators.py:156-159, whatever compute_dtype
    is)."""
    cfg = ckpt.load_config(AVOID).with_overrides(mcts_rollout_impl=impl,
                                                 **BF16)
    sim = sims.LearnedSimulator(StoveModel.from_run(AVOID, cfg=cfg,
                                                    device="cpu"))
    assert sim.leaf_dtype == leaf
    seen = []
    real = fr.rollout

    def spy(dyn_params, c, z0, horizon, sample=True, generator=None,
            prepared=None, actions=None, dtype=None):
        seen.append((horizon, dtype))
        return real(dyn_params, c, z0, horizon, sample, generator, prepared,
                    actions, dtype)

    monkeypatch.setattr(fr, "rollout", spy)
    z = _t(_z0(cfg, 6, 11))
    eval_acts = torch.randint(0, cfg.num_actions, (6, 5),
                              generator=torch.Generator().manual_seed(1))
    sim.step_and_value(z, torch.arange(6) % cfg.num_actions, eval_acts)
    assert seen == [(1, "dense_bf16"), (5, leaf)]


def test_train_and_eval_at_bf16_through_the_cli(tmp_path, capsys):
    """`python -m stove_tpu_torch.main ... compute_dtype=bfloat16
    device=cpu`: a shrunk billiards run trains through the kernel impls'
    plain versions (the SuPAIR warm-up and the ELBO, finite losses, a
    checkpoint and the GIF dumps), and its mode=eval restores it at bf16."""
    run = tmp_path / "runs"
    argv = ["preset=stove_billiards", "num_train=8", "num_test=4",
            "seq_len=20", "batch_size=4", "num_epochs=2", "eval_batch=2",
            "encoder_channels=(8,16)", "encoder_mlp_hidden=32",
            "obj_spn_num_sums=3", "obj_spn_num_leaves=3",
            "obj_spn_repetitions=2", "obj_spn_depth=1", "bg_spn_num_sums=2",
            "bg_spn_num_leaves=2", "bg_spn_depth=2", "bg_spn_repetitions=1",
            "dyn_hidden=32", "cl=4", "supair_only_epochs=1",
            "steps_per_epoch=2", "debug=true", "compute_dtype=bfloat16",
            "scan_impl=pallas", "likelihood_impl=pallas", "device=cpu",
            f"run_dir={run}", f"data_dir={tmp_path / 'data'}"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train]" in out and "elbo=" in out
    rdir = next(run.iterdir())
    assert (rdir / "ckpt_00000004.npz").exists()
    assert len(list(rdir.glob("rollout_ep*.gif"))) == 2
    assert ckpt.load_config(str(rdir)).compute_dtype == "bfloat16"
    m = tmain.run_eval(ckpt.load_config(str(rdir)).with_overrides(
        restore=str(rdir), data_dir=str(tmp_path / "data")), "cpu")
    assert np.isfinite(float(m["mse_final"]))
