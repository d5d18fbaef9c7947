"""The avoidance slice on the CPU: the action-conditioned rollout with its
reward head, inference with actions, the reward metrics and the weights
of ckpts/r4a_dense_s2, each against the JAX package on the same inputs;
the rollout kernel's packed layout and support checks; the eval band that
chip_smoke.py holds the card to; the two repairs of the port's eval.  The
environment's tests are in tests/test_torch_avoidance_physics.py.

Tolerances: the rollout's states 1e-4 and rewards 1e-5 over 4 steps of
the trained map (as tests/test_pallas.py holds the reference's kernel);
infer 1e-4 (the posterior recursion amplifies rounding like the rollout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.ops import pallas_rollout as jpr
from stove_tpu.train import checkpoint as jckpt
from stove_tpu.train import evaluate as jeval
import chip_smoke
from stove_tpu_torch import main as tmain
from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.models.supair import JAX_SPEC_SEEDS
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.train import checkpoint as ckpt
from stove_tpu_torch.train import evaluate as teval
from stove_tpu_torch.train.trainer import Trainer
from torch_parity import jax_infer_noise, to_jax

RUN = "ckpts/r4a_dense_s2"

# chip_smoke.py phase (14) holds the card's mode=eval of RUN to AVOID_BAND:
# the range of the JAX package's float32 metrics on the port's own test
# corpus (data.split(cfg, "test"): 300 sequences, the first eval_batch =
# 100 evaluated) over the posterior draws of jax.random.key(0..31),
# widened by half its width on each side.  test_eval_band_from_the_jax_package
# recomputes those draws and the port's own CPU value and checks them.
EVAL_BAND = chip_smoke.AVOID_BAND


@pytest.fixture(scope="module")
def run():
    cfg = ckpt.load_config(RUN)
    model = StoveModel.from_run(RUN, device="cpu")
    return cfg, model, to_jax(model.params)


# ---------------------------------------------------------------- weights

def test_weights_carry_over_through_both_loaders(run):
    """ckpts/r4a_dense_s2 read by the JAX package's restore and by the
    port's loader: every leaf, the action rows of embed[0] and both reward
    heads included, equal."""
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
    dyn = model.params["dynamics"]
    D, A, h = cfg.full_state_dim, cfg.num_actions, cfg.dyn_hidden
    assert tuple(dyn["embed"][0]["w"].shape) == (D + A, h)
    for head in ("reward", "reward_att"):
        assert [tuple(l["w"].shape) for l in dyn[head]] == \
            [(2 * h + 2, h), (h, h), (h, 1)]
    assert (cfg.seed, cfg.obj_spn_repetitions,
            cfg.bg_spn_repetitions) in JAX_SPEC_SEEDS


# ---------------------------------------------------------------- rollout

def _z0(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.zeros(B, cfg.num_obj, cfg.full_state_dim)
    z[..., 0:2] = 0.24 + 0.05 * torch.rand(B, cfg.num_obj, 2, generator=g)
    z[..., 2:4] = torch.rand(B, cfg.num_obj, 2, generator=g) * 1.4 - 0.7
    z[..., 4:6] = torch.randn(B, cfg.num_obj, 2, generator=g) * 0.05
    z[..., 6:] = torch.randn(B, cfg.num_obj, cfg.cl, generator=g) * 0.5
    return z


def test_rollout_with_actions_matches_jax_rollout_act(run):
    cfg, model, jparams = run
    B, H = 8, 4
    z0 = _z0(cfg, B, 0)
    acts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.num_actions, (B, H)))
    states, rewards = fr.rollout(model.params["dynamics"], cfg, z0, H,
                                 sample=False, actions=acts)
    jcfg = JConfig.from_json(cfg.to_json())
    prep = jpr.prepare_params(jparams["dynamics"], jcfg, jnp.float32)
    js, jr = jpr.rollout_act(prep, jcfg, jnp.asarray(z0.numpy()),
                             jnp.asarray(acts.numpy(), jnp.int32), H, 0,
                             sample=False, block=B, dtype=jnp.float32,
                             interpret=True)
    np.testing.assert_allclose(states.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-5)
    assert float(rewards.min()) < 0.5 < float(rewards.max())


def _kernel_math(flat, cfg, z, acts):
    """The kernel's data flow from the packed buffer, one step at a time:
    the action row added before layer 0's ReLU, the (2h, 2h) reward layer
    over [s ; r] plus the gap and distance rows, the pooled sigmoid."""
    seg, off = {}, 0
    for name, shape in fr.param_layout(cfg):
        n = int(np.prod(shape))
        seg[name] = flat[off:off + n].reshape(shape)
        off += n
    assert off == flat.numel()
    p = seg
    O, h, cl = cfg.num_obj, cfg.dyn_hidden, cfg.cl
    zs, rs_out = [], []
    for t in range(acts.shape[1]):
        x = z @ p["w_e0"] + p["b_e0"] + p["w_e0a"][acts[:, t]][:, None]
        e = torch.relu(x) @ p["w_e1"] + p["b_e1"]
        s = torch.relu(e @ p["w_s0"] + p["b_s0"]) @ p["w_s1"] + p["b_s1"]
        rs = e @ p["w_rs"]
        r = torch.zeros_like(s)
        for o in range(O):
            for j in range(O):
                if j != o:
                    h1 = torch.relu(rs[:, o, :h] + rs[:, j, h:] + p["b_r0"])
                    h2 = torch.relu(h1 @ p["w_r1"] + p["b_r1"])
                    att = torch.sigmoid(h2 @ p["w_ra"] + p["b_ra"][0])
                    r[:, o] += (h2 @ p["w_rf"] + p["b_rf"]) * att[:, None]
        sr = torch.cat([s, r], -1)
        out = torch.relu(torch.relu(sr @ p["w_o0"] + p["b_o0"]) @ p["w_o1"]
                         + p["b_o1"]) @ p["w_o2"] + p["b_o2"]
        vel = z[..., 4:6] + out[..., 0:2]
        z = torch.cat([z[..., :2], z[..., 2:4] + vel, vel,
                       z[..., 6:] + out[..., 2:2 + cl]], -1)
        pos, size = z[..., 2:4], z[..., 0:2].mean(-1)
        d = torch.sqrt(((pos[:, :, None] - pos[:, None]) ** 2).sum(-1)
                       + 1e-8)
        off_diag = ~torch.eye(O, dtype=torch.bool)
        gap = torch.where(off_diag, d - (size[:, :, None] + size[:, None]),
                          torch.inf).amin(-1)
        dist = torch.where(off_diag, d, torch.inf).amin(-1)
        f0 = torch.relu(sr @ p["w_h0"] + p["b_h0"] + gap[..., None] * p["w_hg"]
                        + dist[..., None] * p["w_hd"])
        score = torch.relu(f0[..., :h] @ p["w_rw1"] + p["b_rw1"]) \
            @ p["w_h2"][:h] + p["b_h2"][0]
        logit = torch.relu(f0[..., h:] @ p["w_ra1"] + p["b_ra1"]) \
            @ p["w_h2"][h:] + p["b_h2"][1]
        zs.append(z)
        rs_out.append(torch.sigmoid((torch.softmax(logit, -1) * score)
                                    .sum(-1)))
    return torch.stack(zs, 1), torch.stack(rs_out, 1)


def test_packed_layout_covers_actions_and_reward_heads(run):
    cfg, model, _ = run
    dyn = model.params["dynamics"]
    flat = fr.prepare_params(dyn, cfg)
    names = [n for n, _ in fr.param_layout(cfg)]
    assert names[-11:] == ["w_e0a", "w_h0", "b_h0", "w_hg", "w_hd", "w_rw1",
                           "b_rw1", "w_ra1", "b_ra1", "w_h2", "b_h2"]
    assert all(int(np.prod(s)) % 4 == 0 for _, s in fr.param_layout(cfg))
    base = sum(int(np.prod(s)) for _, s in fr.param_layout(
        cfg.with_overrides(action_conditioned=False, reward_head=False)))
    h = cfg.dyn_hidden
    assert flat.numel() == base + cfg.num_actions * h + 4 * h * h \
        + 8 * h + 2 * h * h + 2 * h + 4
    z0 = _z0(cfg, 8, 2)
    acts = torch.randint(0, 9, (8, 3), generator=torch.Generator()
                         .manual_seed(3))
    want_s, want_r = fr.rollout_states_reference(dyn, cfg, z0, 3, None, acts)
    got_s, got_r = _kernel_math(flat, cfg, z0, acts)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_r, want_r, rtol=0, atol=1e-5)
    # the job builds a separate library for the actions and the reward head
    src, defines = fr.job(cfg)
    assert src == "rollout.cu"
    assert {"-DSTOVE_ACT=1", "-DSTOVE_NA=9", "-DSTOVE_REW=1"} <= set(defines)
    assert not any("ACT" in d or "REW" in d for d in fr.job(
        ckpt.load_config("ckpts/r4rp_bill_s32"))[1])


def test_check_supported_takes_actions_and_the_reward_head(run):
    """Actions, the reward head and, on top of them, an open-loop std head
    (the rollout_act case of pallas_rollout.py:510, which no committed run
    has) are supported; an open head of another depth is not."""
    cfg, model, _ = run
    fr.check_supported(cfg, model.params["dynamics"])
    open_cfg = cfg.with_overrides(open_loop_sigma=True)
    h = cfg.dyn_hidden
    params = dict(model.params["dynamics"], open=[
        {"w": torch.zeros(2 * h, h), "b": torch.zeros(h)},
        {"w": torch.zeros(h, 4 + cfg.cl), "b": torch.zeros(4 + cfg.cl)}])
    fr.check_supported(open_cfg, params)
    assert fr.has_open_head(open_cfg, params)
    assert fr.prepare_params(params, open_cfg).numel() == \
        fr.param_count(open_cfg, True) > fr.param_count(cfg)
    with pytest.raises(ValueError, match="two-layer"):
        fr.check_supported(open_cfg, dict(params, open=params["open"][:1]))


def test_cpu_rollout_takes_actions_without_a_kernel(run):
    cfg, model, _ = run
    before = fr.launch_kernel.launches
    z0 = _z0(cfg, 4, 4)
    acts = torch.randint(0, 9, (4, 2), generator=torch.Generator()
                         .manual_seed(5))
    s, r = model.rollout(z0, acts, 2)
    want = fr.rollout_states_reference(model.params["dynamics"], cfg, z0, 2,
                                       None, acts)
    torch.testing.assert_close(s, want[0], rtol=0, atol=0)
    torch.testing.assert_close(r, want[1], rtol=0, atol=0)
    assert fr.launch_kernel.launches == before


# ---------------------------------------------------------------- infer

def test_infer_with_actions_matches_jax(run):
    cfg, model, jparams = run
    jcfg = JConfig.from_json(cfg.with_overrides(seq_len=12).to_json())
    jep = jdata.generate(jcfg, 4, jax.random.key(7))
    frames = jdata.normalize_frames(jep.frames)
    key = jax.random.key(8)
    jmodel = JModel(jcfg)
    want = jmodel.infer(jparams, frames, jep.actions, key)
    got = model.infer(torch.from_numpy(np.array(frames)),
                      torch.from_numpy(np.array(jep.actions)).long(),
                      jax_infer_noise(key, jcfg, 4, 12))
    for name in ("z", "z_mean", "pos_mean", "rewards"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.kl.numpy(), np.asarray(want.kl),
                               rtol=1e-4)
    assert np.asarray(jep.actions).any()


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("score,label", [
    ([0.1, 0.4, 0.35, 0.8], [0, 0, 1, 1]),
    ([0.5, 0.5, 0.5, 0.2, 0.9, 0.2], [1, 0, 1, 0, 1, 1]),      # ties
    ([0.3, 0.1, 0.7], [1, 1, 1]),                              # one class
    ([0.3, 0.1, 0.7], [0, 0, 0]),
], ids=["plain", "ties", "all_positive", "all_negative"])
def test_binary_auc_matches_jax(score, label):
    got = teval.binary_auc(torch.tensor(score), torch.tensor(label,
                                                             dtype=torch.float32))
    want = jeval.binary_auc(jnp.asarray(score, jnp.float32),
                            jnp.asarray(label, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               equal_nan=True)


def test_reward_metrics_match_jax(run):
    cfg, model, jparams = run
    jcfg = JConfig.from_json(cfg.with_overrides(seq_len=24,
                                                eval_batch=8).to_json())
    jep = jdata.generate(jcfg, 8, jax.random.key(9))
    key = jax.random.key(0)
    want = jeval.rollout_metrics(JModel(jcfg), jparams, jep, key)
    tcfg = Config.from_json(jcfg.to_json())
    tmodel = StoveModel(tcfg, model.params, "cpu", model.seeds)
    tep = tdata.Episode(*(torch.from_numpy(np.array(a)) for a in jep))
    tep = tep._replace(actions=tep.actions.long())
    k_inf, _ = jax.random.split(key)
    got = teval.rollout_metrics(
        tmodel, tep, noise=jax_infer_noise(k_inf, jcfg, 8, jcfg.window))
    assert {"reward_mae", "reward_auc", "reward_auc_per_step"} <= set(got)
    assert set(got) == set(want)
    for k in ("reward_mae", "reward_auc", "reward_auc_per_step", "mse_final",
              "detect_mse"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, equal_nan=True,
                                   err_msg=k)


@pytest.fixture(scope="module")
def eval_corpus(run):
    cfg, _, _ = run
    tep = tdata.split(cfg, "test")
    assert tep.frames.shape[0] == cfg.num_test == 300
    jcfg = JConfig.from_json(cfg.to_json())
    jep = jdata.Episode(*(jnp.asarray(x.numpy()) for x in tep))
    jmodel = JModel(jcfg)
    metrics = jax.jit(lambda p, k: jeval.rollout_metrics(jmodel, p, jep, k))
    return tep, jcfg, metrics


def test_eval_matches_jax_on_its_noise(run, eval_corpus, capsys):
    """At mode=eval's own size (the 300-sequence test split, 100
    evaluated), the port's rollout_metrics under the posterior noise that
    jax.random.key(0) draws equal the JAX package's under that key."""
    cfg, model, jparams = run
    tep, jcfg, metrics = eval_corpus
    key = jax.random.key(0)
    want = metrics(jparams, key)
    k_inf, _ = jax.random.split(key)
    got = teval.rollout_metrics(model, tep, noise=jax_infer_noise(
        k_inf, jcfg, cfg.eval_batch, cfg.window))
    keys = ("mse_final", "detect_mse", "reward_auc", "reward_mae",
            "reward_auc_per_step")
    rel = {k: float(np.max(np.abs(np.asarray(got[k])
                                  / np.asarray(want[k]) - 1))) for k in keys}
    with capsys.disabled():
        print("\n[same noise] jax key 0, port / jax - 1: " + " ".join(
            f"{k} {v:.2e}" for k, v in rel.items()))
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, equal_nan=True,
                                   err_msg=k)


def test_eval_band_from_the_jax_package(run, eval_corpus, capsys):
    """The JAX package's float32 metrics on the port's test corpus over
    32 posterior draws set the band (their range, widened by half its
    width); the port's own CPU mode=eval, another draw of the same
    function (test_eval_matches_jax_on_its_noise), lies in the draws'
    range."""
    cfg, _, jparams = run
    _, _, metrics = eval_corpus
    rows = []
    for seed in range(32):
        m = metrics(jparams, jax.random.key(seed))
        rows.append({k: float(m[k]) for k in EVAL_BAND})
    port = tmain.run_eval(cfg.with_overrides(restore=RUN), "cpu")
    with capsys.disabled():
        for k in EVAL_BAND:
            v = np.array([r[k] for r in rows])
            print(f"\n[eval band] jax keys 0-31: {k} min {v.min():.6g} max "
                  f"{v.max():.6g} mean {v.mean():.6g} std {v.std():.3g}; "
                  f"port cpu {float(port[k]):.6g}", end="")
        print()
    for k, (lo, hi) in EVAL_BAND.items():
        a = min(r[k] for r in rows)
        b = max(r[k] for r in rows)
        assert lo <= a - (b - a) / 2 <= a and b <= b + (b - a) / 2 <= hi, \
            (k, a, b, (lo, hi))
        assert a <= float(port[k]) <= b, (k, float(port[k]), a, b)


# ---------------------------------------------------------------- repairs

def test_bfloat16_compute_dtype_raises():
    cfg = Config().debug_shrunk().with_overrides(compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        StoveModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        tmain.main(["preset=stove_billiards", "debug=true",
                    "compute_dtype=bfloat16", "device=cpu", "nolog=true"])


def test_eval_corpus_is_the_trainers_test_split(tmp_path, monkeypatch):
    """mode=eval scores the corpus the Trainer evaluates on: cfg.num_test
    sequences from seed + 1."""
    cfg = Config().debug_shrunk().with_overrides(
        run_dir=str(tmp_path), nolog=True, num_test=5, seq_len=20)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.test_ep.frames.shape[0] == 5
    seen = []
    real_split = tdata.split
    monkeypatch.setattr(tdata, "split", lambda c, name, device:
                        seen.append(real_split(c, name, device)) or seen[-1])
    monkeypatch.setattr(StoveModel, "from_run",
                        classmethod(lambda cls, *a, **k: trainer.model))
    tmain.run_eval(cfg.with_overrides(restore=str(tmp_path)), "cpu")
    assert len(seen) == 1
    for a, b in zip(seen[0], trainer.test_ep):
        assert torch.equal(a, b)
