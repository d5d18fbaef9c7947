"""The bfloat16 variant of the rollout and scan kernels, on the CPU.

The TPU kernels' default precision (`pallas_rollout.prepare_params(...,
jnp.bfloat16)`, `make_mm`) rounds both operands of every matmul to bf16 and
sums in f32.  The port's plain versions at dtype "bfloat16"
(`fused_rollout.rollout_states_reference`, `fused_scan.scan_reference`,
`dynamics.apply(bf16=True)`) are held to those kernels in interpret mode on
the same weights and inputs (made from numpy seeds) at steps 1-4: the
port's distance from JAX's bf16 kernel is at most 0.1 times the distance
between JAX's bf16 and f32 kernels in the median over all entries of a
step and in the median over the (sample, object) entries of each state
column (and of the rewards) -- the same rounding points, not a looser f32
match: a wrong or missing rounding point moves every sample by a share of
the bf16 - f32 distance.  The maximum over entries is not held to 0.1x:
two f32 sums of the same bf16 products taken in another order (XLA's dot,
torch's matmul, the card's mma) now and then round an activation to
neighbouring bf16 values, a flip of one bf16 ulp that moves that one
(sample, object) row, by as much as the largest bf16 - f32 distance near
a collision, and grows with it over the steps (seen for the avoidance
model at B=16: one row of 48 at step 1, 7.3e-3 against 4.0e-2; on the
card, over 24 seeded input draws, up to 1.05x); a median over samples
ignores such rows while a wrong rounding point cannot hide in it.  The rows a flip
moves are held apart (`bf16_parity`): the largest distance at most 2x
the bf16 - f32 maximum, and at most 1e-2 of the entries (3e-2 of the
rewards, or one row's where that is more) above 0.1x it, so a fault in a
share of the rows -- one sample of a block, one warp's rows, one object
of a 16-sample block -- fails.

Also here: the planner's leaf precision under `mcts_rollout_impl`, the
scan dispatch's bf16 forward with its float32 backward, the fragment-order
packing of `prepare_params`, and the tile choice.  The kernels themselves
are held to these plain versions on the card (tests marked `cuda` in
test_torch_fused_rollout.py and test_torch_training_kernels.py, and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import dynamics as jdyn
from stove_tpu.ops import pallas_rollout as jpr
from stove_tpu.ops import pallas_scan as jps
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan
from stove_tpu_torch.planning import simulators as sims
from stove_tpu_torch.train import checkpoint as ckpt
from bf16_parity import REWARDS, hold_bf16
from torch_parity import to_jax

BILL, AVOID, GRAV = ("ckpts/r4rp_bill_s32", "ckpts/r4a_dense_s2",
                     "ckpts/r4rp_grav_s32")
STEPS = 4


def _z0(cfg, B, seed):
    rng = np.random.default_rng(seed)
    O, D = cfg.num_obj, cfg.full_state_dim
    z = np.zeros((B, O, D), np.float32)
    z[..., 0:2] = 0.24
    z[..., 2:4] = rng.uniform(-0.7, 0.7, (B, O, 2))
    z[..., 4:6] = rng.normal(0.0, 0.05, (B, O, 2))
    z[..., 6:] = rng.normal(0.0, 0.5, (B, O, cfg.cl))
    return z


def _jax_rollout(jdyn_p, jc, z0, acts, dtype):
    prep = jpr.prepare_params(jdyn_p, jc, dtype)
    B = z0.shape[0]
    if acts is None:
        s = jpr.rollout_states(prep, jc, jnp.asarray(z0), STEPS, 0,
                               sample=False, block=B, dtype=dtype,
                               interpret=True)
        return np.asarray(s), None
    s, r = jpr.rollout_act(prep, jc, jnp.asarray(z0), jnp.asarray(acts),
                           STEPS, 0, sample=False, block=B, dtype=dtype,
                           interpret=True)
    return np.asarray(s), np.asarray(r)


def _random_weights():
    """debug_shrunk random weights, the last output layer moved off zero
    so the dynamics move (as tests/test_pallas.py perturbs it)."""
    jc = JConfig().debug_shrunk()
    p = jdyn.init_params(jax.random.key(1), jc)
    p["out"][-1]["w"] = 0.05 * jax.random.normal(jax.random.key(5),
                                                 p["out"][-1]["w"].shape)
    cfg = Config.from_json(jc.to_json())
    return cfg, ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), "cpu")


@pytest.mark.parametrize("case", ["random_weights", "billiards", "avoidance"])
def test_plain_bf16_rollout_matches_jax_bf16_kernel(case):
    """The mean rollout (rollout_states; rollout_act with the reward head for
    the avoidance model) of the port's plain bf16 version against JAX's
    bf16 kernel, B=16 (its rewards too)."""
    if case == "random_weights":
        cfg, dyn = _random_weights()
    else:
        run = BILL if case == "billiards" else AVOID
        cfg, dyn = ckpt.load_config(run), ckpt.load_params(run, device="cpu")[
            "dynamics"]
    jc = JConfig.from_json(cfg.to_json())
    jdyn_p = to_jax(dyn)
    z0 = _z0(cfg, 16, 3)
    acts = None
    if cfg.action_conditioned:
        acts = np.random.default_rng(4).integers(
            0, cfg.num_actions, (16, STEPS)).astype(np.int32)
    js, jr = _jax_rollout(jdyn_p, jc, z0, acts, jnp.bfloat16)
    fs, fr32 = _jax_rollout(jdyn_p, jc, z0, acts, jnp.float32)
    ps, prew = fr.rollout(dyn, cfg, torch.from_numpy(z0), STEPS, False,
                          actions=None if acts is None
                          else torch.from_numpy(acts).long(),
                          dtype="bfloat16")
    hold_bf16(f"{case} states", ps, js, fs)
    if jr is not None:
        hold_bf16(f"{case} rewards", prew, jr, fr32, **REWARDS)
    assert fr.launch_kernel.launches == 0


def test_plain_bf16_scan_matches_jax_bf16_kernel():
    """scan_reference at bf16 against pallas_scan.scan_fused(...,
    dtype=jnp.bfloat16, interpret=True): trained avoidance weights (actions
    and the reward head), B=8, T2=4, inputs from numpy seeds; z, z_mean and
    the rewards by step."""
    cfg = ckpt.load_config(AVOID)
    dyn = ckpt.load_params(AVOID, device="cpu")["dynamics"]
    jc = JConfig.from_json(cfg.to_json())
    jdyn_p = to_jax(dyn)
    rng = np.random.default_rng(7)
    B, T2, O, D = 8, STEPS, cfg.num_obj, cfg.full_state_dim
    f32 = np.float32
    args = [_z0(cfg, B, 8),
            rng.normal(0, 0.3, (B, O, 2)).astype(f32),
            (0.05 + 0.1 * rng.uniform(size=(B, O, 2))).astype(f32),
            rng.normal(0, 0.3, (B, T2, O, 4)).astype(f32),
            (0.05 + 0.1 * rng.uniform(size=(B, T2, O, 4))).astype(f32),
            rng.integers(0, cfg.num_actions, (B, T2)).astype(np.int32),
            rng.normal(size=(B, T2, O, D)).astype(f32)]
    want = {dt: jps.scan_fused(jpr.prepare_params(jdyn_p, jc, dt), jc,
                               *map(jnp.asarray, args), block=B, dtype=dt,
                               interpret=True)
            for dt in (jnp.float32, jnp.bfloat16)}
    targs = [torch.from_numpy(a) for a in args]
    targs[5] = targs[5].long()
    got = fused_scan.scan_reference(dyn, cfg, *targs, dtype="bfloat16")
    for i, name in ((0, "z"), (1, "z_mean"), (3, "rewards")):
        hold_bf16(f"scan {name}", got[i], want[jnp.bfloat16][i],
                  want[jnp.float32][i], **(REWARDS if i == 3 else {}))
    kb, kf = (np.asarray(want[dt][2]) for dt in (jnp.bfloat16, jnp.float32))
    assert np.abs(got[2].numpy() - kb).max() <= 0.1 * np.abs(kb - kf).max()


def test_scan_dispatch_runs_bf16_forward_and_f32_backward():
    """scan_impl="pallas" (`fused_scan.scan_fused`, the plain loop on the
    CPU): its outputs are the bf16 plain loop's, bit for bit, and its
    gradient is the float32 plain loop's VJP at their cotangents, as
    `_scan_pallas_fwd`/`_scan_pallas_bwd` (stove.py:304-333)."""
    cfg = ckpt.load_config(AVOID)
    dyn = ckpt.load_params(AVOID, device="cpu")["dynamics"]
    g = torch.Generator().manual_seed(9)
    B, T2, O, D = 4, 3, cfg.num_obj, cfg.full_state_dim
    ins = [torch.from_numpy(_z0(cfg, B, 9)), 0.3 * torch.randn(B, O, 2,
                                                                 generator=g),
           0.1 + 0.1 * torch.rand(B, O, 2, generator=g),
           0.3 * torch.randn(B, T2, O, 4, generator=g),
           0.05 + 0.1 * torch.rand(B, T2, O, 4, generator=g),
           torch.randint(0, cfg.num_actions, (B, T2), generator=g),
           torch.randn(B, T2, O, D, generator=g)]

    def leaves():
        return [x.clone().requires_grad_(True) for x in tree.leaves(dyn)]

    lv = leaves()
    out = fused_scan.scan_fused(tree.unflatten(dyn, lv), cfg, *ins)
    bf = fused_scan.scan_reference(dyn, cfg, *ins, dtype="bfloat16")
    f32 = fused_scan.scan_reference(dyn, cfg, *ins)
    for a, b, c in zip(out, bf, f32):
        assert torch.equal(a.detach(), b)
    assert (out[0] - f32[0]).abs().max() > 1e-3      # bf16, not f32
    (out[0].square().sum() + out[2].sum() + out[3].sum()).backward()
    lv2 = leaves()
    ref = fused_scan.scan_reference(tree.unflatten(dyn, lv2), cfg, *ins)
    torch.autograd.backward([ref[0], ref[2], ref[3]],
                            [2 * out[0].detach(), torch.ones(B),
                             torch.ones(B, T2)])
    for a, b in zip(lv, lv2):
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad)
    assert fused_scan.launch_kernel.launches == 0


@pytest.mark.parametrize("impl,leaf", [("pallas", "bfloat16"),
                                       ("xla", "float32")])
def test_planner_leaf_precision_follows_mcts_rollout_impl(impl, leaf,
                                                          monkeypatch):
    """`LearnedSimulator` values leaves with the bf16 rollout under
    mcts_rollout_impl=pallas and the float32 one under xla (the JAX
    planner's simulators.py:147-158); its step is float32 either way, and
    the leaf values are those of the plain rollout at that precision."""
    cfg = ckpt.load_config(AVOID).with_overrides(mcts_rollout_impl=impl)
    model = StoveModel.from_run(AVOID, cfg=cfg, device="cpu")
    sim = sims.LearnedSimulator(model)
    assert sim.leaf_dtype == leaf
    seen = []
    real = fr.rollout

    def spy(dyn_params, c, z0, horizon, sample=True, generator=None,
            prepared=None, actions=None, dtype="float32"):
        seen.append((horizon, dtype))
        return real(dyn_params, c, z0, horizon, sample, generator, prepared,
                    actions, dtype)

    monkeypatch.setattr(fr, "rollout", spy)
    z = torch.from_numpy(_z0(cfg, 6, 11))
    acts = torch.arange(6) % cfg.num_actions
    eval_acts = torch.randint(0, cfg.num_actions, (6, 5),
                              generator=torch.Generator().manual_seed(1))
    nxt, _, ret = sim.step_and_value(z, acts, eval_acts)
    assert seen == [(1, "float32"), (5, leaf)]
    _, rew = fr.rollout_states_reference(model.params["dynamics"], cfg, nxt,
                                         5, None, eval_acts, leaf)
    other = "float32" if leaf == "bfloat16" else "bfloat16"
    _, rew_o = fr.rollout_states_reference(model.params["dynamics"], cfg,
                                           nxt, 5, None, eval_acts, other)
    p = sim._depth_shrink(sim._calibrate(rew))
    disc = cfg.mcts_discount ** torch.arange(5, dtype=p.dtype)
    torch.testing.assert_close(ret, (p * disc).sum(1), rtol=0, atol=1e-6)
    assert (rew - rew_o).abs().max() > 1e-5


def test_tree_mode_with_the_fused_rollout_raises():
    cfg = ckpt.load_config(AVOID).with_overrides(
        mcts_rollout_impl="pallas", mcts_shrink_mode="tree",
        mcts_depth_shrink=0.9)
    with pytest.raises(ValueError, match="tree"):
        sims.LearnedSimulator(StoveModel.from_run(AVOID, cfg=cfg,
                                                  device="cpu"))


@pytest.mark.parametrize("dtype", fr.DTYPES)
@pytest.mark.parametrize("run", [BILL, AVOID, GRAV])
def test_packed_weights_unpack_to_the_checkpoint(run, dtype):
    """`prepare_params` at each precision unpacks to the checkpoint's
    weights: every segment of `flat_params` (the matrices and embed[0]'s
    action rows rounded to bf16 in the bf16 buffer, embed layer 0 padded
    with zero rows to K = 32), in `kernel_layout` order; the buffer without
    the open-loop head is the prefix of the buffer with it."""
    cfg = ckpt.load_config(run)
    dyn = ckpt.load_params(run, device="cpu")["dynamics"]
    kcfg = fr.kernel_config(cfg, dyn)
    open_head = fr.has_open_head(cfg, dyn)
    buf = fr.prepare_params(dyn, cfg, dtype)
    assert buf.dtype == torch.uint8
    assert buf.numel() == fr.kernel_bytes(kcfg, open_head, dtype)
    got = fr.unpack_params(buf, kcfg, open_head, dtype)
    flat, off = fr.flat_params(dyn, cfg), 0
    mats = {n for n, _, m in fr.kernel_layout(kcfg, open_head) if m}
    for name, shape in fr.param_layout(kcfg, open_head):
        want = flat[off:off + int(np.prod(shape))].reshape(shape)
        off += want.numel()
        if dtype == "bfloat16" and (name in mats or name == "w_e0a"):
            want = dyn_lib.bf16_round(want)
        g = got[name]
        if name == "w_e0":
            assert not g[shape[0]:].any()
            g = g[:shape[0]]
        assert torch.equal(g, want), name
    # the checkpoint's own tensors, where a segment is one of them
    torch.testing.assert_close(got["w_e1"], dyn_lib.bf16_round(
        dyn["embed"][1]["w"]) if dtype == "bfloat16" else dyn["embed"][1]["w"],
        rtol=0, atol=0)
    torch.testing.assert_close(got["w_ra"], dyn["rel"][2]["w"][:, -1],
                               rtol=0, atol=0)
    if open_head:
        base = fr.kernel_bytes(kcfg, False, dtype)
        assert torch.equal(buf[:base], fr.prepare_params(
            {k: v for k, v in dyn.items() if k != "open"}, cfg, dtype))


def test_tile_and_library_choice():
    """The small tile when 16 samples a block would leave SMs empty; the
    precision and the tile are compile-time defines of separate
    libraries."""
    assert fr.tile_for(576) == fr.tile_for(100) == fr.tile_for(1) == 4
    assert fr.tile_for(16 * 131) == 4 and fr.tile_for(16 * 132) == 16
    assert fr.tile_for(16384) == 16
    cfg = ckpt.load_config(AVOID)
    src, d = fr.job(cfg, False, "bfloat16", 4)
    assert src == "rollout.cu" and {"-DSTOVE_BF16=1", "-DSTOVE_TB=4"} <= set(d)
    assert not any("BF16" in x for x in fr.job(cfg)[1])
    assert "-DSTOVE_BF16=1" in fused_scan.job(cfg, "bfloat16")[1]
    assert not any("BF16" in x for x in fused_scan.job(cfg)[1])
    with pytest.raises(ValueError, match="dtype"):
        fr.rollout_states_reference({}, cfg, torch.zeros(1, 3, 22), 1,
                                    dtype="float16")


def test_model_rollout_takes_a_dtype():
    """`StoveModel.rollout` and `stove.rollout` pass the precision through
    to the dispatch: on the CPU the plain version at that precision."""
    model = StoveModel.from_run(BILL, device="cpu")
    z0 = torch.from_numpy(_z0(model.cfg, 4, 12))
    for dtype in fr.DTYPES:
        got, _ = model.rollout(z0, None, 3, dtype=dtype)
        want, _ = fr.rollout_states_reference(model.params["dynamics"],
                                              model.cfg, z0, 3, dtype=dtype)
        assert torch.equal(got, want)
        got2, _ = tstove.rollout(model.params, model.cfg, z0, None, 3,
                                 dtype=dtype)
        assert torch.equal(got2, want)
    assert model.prepared_for("bfloat16") is None      # packed on the card
