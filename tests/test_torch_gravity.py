"""The gravity slice on the CPU: the environment, the weights of
ckpts/r4rp_grav_s32 with their open-loop std head, the sampled rollout's
open-loop std and its packed layout, and the resume band that
chip_smoke.py holds the card to, each against the JAX package on the same
inputs (the eval band: tests/test_torch_gravity_eval.py).

Tolerances: physics 1e-4 arena units over 30 steps (as the billiards and
avoidance physics); the open-loop std 1e-5 (one step of the dynamics and
the head, float32 sums in another order); the packed buffer's open head
against JAX's prepare_params exactly (a copy); the ELBO terms 1e-5
relative on the JAX package's own noise (as tests/test_torch_resume.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import physics as jphys
from stove_tpu.models import dynamics as jdyn
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.ops import pallas_rollout as jpr
from stove_tpu.train import checkpoint as jckpt
import chip_smoke
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.envs import physics as tphys
from stove_tpu_torch.models import dynamics as tdyn
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_elbo_noise, to_jax

RUN = "ckpts/r4rp_grav_s32"


@pytest.fixture(scope="module")
def run():
    cfg = ckpt.load_config(RUN)
    model = StoveModel.from_run(RUN, device="cpu")
    return cfg, model, to_jax(model.params)


def _jstate(cfg, n, seed):
    jcfg = JConfig.from_json(cfg.to_json())
    keys = jax.random.split(jax.random.key(seed), n)
    return jcfg, jax.vmap(lambda k: jphys.init_state(jcfg, k))(keys)


# ---------------------------------------------------------------- physics

def test_gravity_physics_matches_jax_over_30_steps(run):
    """30 steps of 8 sequences from the JAX package's initial states, held
    to the JAX step evaluated op by op (jax.disable_jit) and, at every
    step, to the jitted step started from the port's state."""
    cfg = run[0]
    jcfg, js = _jstate(cfg, 8, 3)
    ts = tphys.EnvState(*(torch.from_numpy(np.array(x)) for x in js))
    eager = jax.vmap(lambda s: jphys.env_step(jcfg, s))
    jitted = jax.jit(eager)
    moved = 0.0
    for _ in range(30):
        one, _ = jitted(jphys.EnvState(*(jnp.asarray(x.numpy())
                                         for x in ts)))
        with jax.disable_jit():
            js, _ = eager(js)
        ts0 = ts
        ts, tr = tphys.env_step(cfg, ts)
        assert not tr.any()
        for got, want in ((ts, js), (ts, one)):
            np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                                       rtol=0, atol=1e-4)
        moved += float((ts.vel - ts0.vel).abs().sum())
    assert moved > 0.1            # the balls attract: velocities change


def test_gravity_init_moments_and_zero_momentum(run):
    """Velocities N(0, 1)·(0.3·init_speed + 0.05) with their mean over the
    O balls removed: zero net momentum (unit masses), per-component std
    σ·sqrt(1 − 1/O) in the port's draws and in the JAX package's; the
    positions do not overlap, as for the other tasks."""
    cfg = run[0]
    n, O = 4096, cfg.num_obj
    s = tphys.init_state(cfg, n, torch.Generator().manual_seed(0))
    _, js = _jstate(cfg, n, 0)
    sigma = (0.3 * cfg.init_speed + 0.05) * (1 - 1 / O) ** 0.5
    for vel in (s.vel.numpy(), np.asarray(js.vel)):
        assert np.abs(vel.sum(1)).max() < 1e-6
        assert abs(vel.std() / sigma - 1) < 0.02, vel.std()
        assert abs(vel.mean()) < 1e-3
    np.testing.assert_array_equal(s.masses.numpy(), np.ones((n, O)))
    d = torch.cdist(s.pos, s.pos) + 1e3 * torch.eye(O)
    assert float(d.min()) >= 2 * cfg.ball_radius - 1e-4


def test_gravity_corpus_draws_no_actions(run):
    """A gravity corpus: the physics' trajectories from the generator's
    initial states, frames rendered from them, no actions, zero rewards."""
    cfg = run[0].with_overrides(seq_len=12)
    ep = tdata.generate(cfg, 4, torch.Generator().manual_seed(2))
    s = tphys.init_state(cfg, 4, torch.Generator().manual_seed(2))
    assert not ep.actions.any() and not ep.rewards.any()
    for t in range(12):
        torch.testing.assert_close(ep.states[:, t],
                                   torch.cat([s.pos, s.vel], -1),
                                   rtol=0, atol=0)
        s = tphys.gravity_step(cfg, s)
    assert ep.frames.dtype == torch.uint8 and ep.frames.float().mean() > 1.0


# ---------------------------------------------------------------- weights

def test_weights_carry_over_with_the_open_head(run):
    """ckpts/r4rp_grav_s32 read by the JAX package's restore and by the
    port's loader: every leaf, the open-loop std head's included, equal."""
    cfg, model, _ = run
    jcfg = JConfig.from_json(cfg.to_json())
    tpl = jax.eval_shape(JModel(jcfg).init_params)
    tpl = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), tpl)
    _, loaded = jckpt.restore(RUN, {"params": tpl})
    want = jax.tree_util.tree_flatten_with_path(loaded["params"])[0]
    assert len(want) == len(jax.tree_util.tree_leaves(to_jax(model.params)))
    for path, leaf in want:
        node = model.params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    h = cfg.dyn_hidden
    assert [tuple(l["w"].shape) for l in model.params["dynamics"]["open"]] \
        == [(2 * h, h), (h, 4 + cfg.cl)]


# ---------------------------------------------------------------- open head

def _z0(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.zeros(B, cfg.num_obj, cfg.full_state_dim)
    z[..., 0:2] = 0.18 + 0.05 * torch.rand(B, cfg.num_obj, 2, generator=g)
    z[..., 2:4] = torch.rand(B, cfg.num_obj, 2, generator=g) * 1.4 - 0.7
    z[..., 4:6] = torch.randn(B, cfg.num_obj, 2, generator=g) * 0.05
    z[..., 6:] = torch.randn(B, cfg.num_obj, cfg.cl, generator=g) * 0.5
    return z


def test_sampled_rollout_std_is_the_open_heads(run):
    """One sampled step of the port's rollout injects JAX's dyn.std_open ×
    rollout_sigma_temp on the same states times its noise (1e-5), floored
    at min_open_std, and not the filter std."""
    cfg, model, jparams = run
    z0 = _z0(cfg, 16, 0)
    noise = torch.randn((16, 1) + tuple(z0.shape[1:]),
                        generator=torch.Generator().manual_seed(1))
    s, _ = fr.rollout_states_reference(model.params["dynamics"], cfg, z0, 1,
                                       noise)
    mean, _ = fr.rollout_states_reference(model.params["dynamics"], cfg, z0,
                                          1)
    jcfg = JConfig.from_json(cfg.to_json())
    j = jdyn.apply(jparams["dynamics"], jcfg, jnp.asarray(z0.numpy()))
    want = np.asarray(j.std_open) * cfg.rollout_sigma_temp
    np.testing.assert_allclose((s - mean)[:, 0].numpy(),
                               want * noise[:, 0].numpy(), rtol=0, atol=1e-5)
    assert want[..., 2:].min() >= cfg.min_open_std
    assert np.abs(want - np.asarray(j.std)).max() > 0.01


def test_packed_open_head_matches_jax_prepare_params(run):
    """The open head closes the packed buffer (after every other segment,
    so the buffer without it is a prefix) and holds JAX's w_op_s, w_op_r,
    b_op0, w_op1, b_op1 (transposed to (in, out), the last layer
    zero-padded); the kernel's data flow from those segments gives the
    std JAX's dynamics give (1e-5)."""
    cfg, model, jparams = run
    dyn = model.params["dynamics"]
    flat = fr.prepare_params(dyn, cfg)
    assert fr.has_open_head(cfg, dyn)
    layout = fr.param_layout(cfg, open_head=True)
    assert [n for n, _ in layout[-4:]] == ["w_op0", "b_op0", "w_op1", "b_op1"]
    assert layout[:-4] == fr.param_layout(cfg)
    assert flat.numel() == fr.param_count(cfg, True)
    torch.testing.assert_close(flat[:fr.param_count(cfg)],
                               fr.pack_params(dyn, cfg), rtol=0, atol=0)
    seg, off = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        seg[name] = flat[off:off + n].reshape(shape).numpy()
        off += n
    jcfg = JConfig.from_json(cfg.to_json())
    jp = jpr.prepare_params(jparams["dynamics"], jcfg, jnp.float32)
    h, w = cfg.dyn_hidden, 4 + cfg.cl
    np.testing.assert_array_equal(seg["w_op0"][:h], np.asarray(jp["w_op_s"]).T)
    np.testing.assert_array_equal(seg["w_op0"][h:], np.asarray(jp["w_op_r"]).T)
    np.testing.assert_array_equal(seg["b_op0"], np.asarray(jp["b_op0"])[:, 0])
    np.testing.assert_array_equal(seg["w_op1"][:, :w], np.asarray(jp["w_op1"]).T)
    np.testing.assert_array_equal(seg["b_op1"][:w], np.asarray(jp["b_op1"])[:, 0])
    assert not seg["w_op1"][:, w:].any() and not seg["b_op1"][w:].any()
    # [s ; r] of the plain dynamics through the packed head, as the kernel
    z0 = _z0(cfg, 8, 2)
    feats = {}
    handle = tdyn.mlp

    def spy(layers, x):
        if layers is dyn["out"]:
            feats["sr"] = x
        return handle(layers, x)

    tdyn.mlp = spy
    try:
        tdyn.apply(dyn, cfg, z0)
    finally:
        tdyn.mlp = handle
    f = torch.relu(feats["sr"] @ torch.from_numpy(seg["w_op0"])
                   + torch.from_numpy(seg["b_op0"]))
    raw = (f @ torch.from_numpy(seg["w_op1"])
           + torch.from_numpy(seg["b_op1"]))[..., :w]
    lo, hi = cfg.min_open_std, cfg.max_dyn_std
    std = lo + (hi - lo) * torch.sigmoid(raw)
    j = jdyn.apply(jparams["dynamics"], jcfg, jnp.asarray(z0.numpy()))
    np.testing.assert_allclose(std.numpy(), np.asarray(j.std_open)[..., 2:],
                               rtol=0, atol=1e-5)


def test_rollout_jobs_by_variant(run):
    """The open-loop library only for the sampled rollout of a model with
    the head; the mean rollout of a gravity model launches the action-free
    library."""
    cfg, model, _ = run
    assert fr.job(cfg) == fr.job(ckpt.load_config("ckpts/r4rp_bill_s32"))
    assert fr.job(cfg, True)[1] == fr.job(cfg)[1] + ("-DSTOVE_OPEN=1",)
    avoid = ckpt.load_config("ckpts/r4a_dense_s2")
    assert fr.job(avoid, True)[1][-4:] == ("-DSTOVE_ACT=1", "-DSTOVE_NA=9",
                                           "-DSTOVE_REW=1", "-DSTOVE_OPEN=1")
    fr.check_supported(cfg, model.params["dynamics"])


# ---------------------------------------------------------------- band

def test_resume_band_from_the_jax_package(run, capsys):
    """What resuming RUN should give: the JAX package's float32 ELBO terms
    at the restored weights on windows of the port's training corpus
    (split(cfg, "train") at 64 sequences), 8 batches of 32 windows under
    JAX's noise; chip_smoke.GRAV_RESUME_BAND is their range widened by
    half its width.  The port equals JAX on the first two batches (1e-5).
    The run's log (elbo 1172.2, open_sigma_nll -42.6 at step 5200) is
    context only."""
    cfg, model, jparams = run
    ep = tdata.split(cfg.with_overrides(num_train=64), "train")
    jm = JModel(JConfig.from_json(cfg.to_json()))
    elbo = jax.jit(jm.elbo)
    g = torch.Generator().manual_seed(100)
    keys = ("elbo", "kl", "overshoot_loss", "open_sigma_nll")
    want, got = [], []
    for i in range(8):
        b = tdata.sample_windows(ep, cfg, g, 32)
        key = jax.random.key(200 + i)
        o = elbo(jparams, jnp.asarray(b["frames"].numpy()), None, None, key)
        want.append([float(getattr(o, k)) for k in keys])
        if i < 2:
            with torch.no_grad():
                t = model.elbo(model.params, b["frames"], None, None,
                               jax_elbo_noise(key, cfg, 32, cfg.window))
            got.append([float(getattr(t, k)) for k in keys])
    want = np.array(want)
    band = chip_smoke.GRAV_RESUME_BAND
    with capsys.disabled():
        for k, v in zip(keys, want.T):
            print(f"\n[grav resume band] jax float32, 8 x 32 windows: {k} "
                  f"min {v.min():.6g} max {v.max():.6g} mean {v.mean():.6g}",
                  end="")
        print()
    np.testing.assert_allclose(np.array(got), want[:2], rtol=1e-5, atol=1e-5)
    for k, v in zip(keys, want.T):
        lo, hi = band[k]
        a, b = v.min(), v.max()
        assert lo <= a - (b - a) / 2 and b + (b - a) / 2 <= hi, \
            (k, a, b, (lo, hi))
