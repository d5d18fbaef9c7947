"""RAT-SPN of the port against `stove_tpu/models/spn.py` and
`stove_tpu/ops/pallas_spn.py`.

* The region graphs: `make_spec` from the port's seed table equals JAX's
  `make_spec` (perms and scopes, exactly) for every seed of the committed
  run directories.
* `spn_log_prob` against the dense JAX path and the numpy oracle, with the
  same parameters and inputs; and `fused_spn.spn_log_prob_fused` on the
  CPU (its plain version, through the autograd function) against the
  Pallas kernel in interpret mode at a small tile.
Tolerances: log-densities of O(10-100) summed in another order, rtol 1e-5
with atol 1e-4; gradients rtol 1e-4, atol 1e-5.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import spn as jspn
from stove_tpu.models import supair as jsup
from stove_tpu.ops import pallas_spn
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import spn as tspn
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.ops import fused_spn
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_spec_seeds

RUN_CONFIGS = sorted(glob.glob("ckpts/*/config.json"))
TOL = dict(rtol=1e-5, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _seed(path):
    return json.load(open(path))["seed"]


@pytest.mark.parametrize("path", RUN_CONFIGS, ids=lambda p: p.split("/")[1])
def test_seed_table_builds_the_jax_region_graphs(path):
    jc = JConfig.from_json(open(path).read())
    tc = TConfig.from_json(jc.to_json())
    want = jsup.make_specs(jax.random.key(jc.seed), jc)
    got = tsup.make_specs(tc, tsup.run_spec_seeds("ckpts/none", tc))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.perms, w.perms)
        np.testing.assert_array_equal(g.scopes, w.scopes)
        assert (g.num_vars, g.depth, g.num_sums, g.num_leaves, g.num_reps,
                g.min_std, g.max_std) == (w.num_vars, w.depth, w.num_sums,
                                          w.num_leaves, w.num_reps,
                                          w.min_std, w.max_std)


def test_seed_table_covers_every_committed_run():
    seeds = {_seed(p) for p in RUN_CONFIGS}
    assert seeds <= {k[0] for k in tsup.JAX_SPEC_SEEDS}
    cfg = TConfig(seed=32, obj_spn_repetitions=4, bg_spn_repetitions=2)
    assert tsup.run_spec_seeds("ckpts/none", cfg) == (
        (1724523911, 97095777, 569149076, 1067226913),
        (1573195128, 1437628542))
    with pytest.raises(KeyError, match="unknown to the port"):
        tsup.run_spec_seeds("ckpts/none", cfg.with_overrides(seed=12345))


def test_fresh_seeds_come_from_a_generator_and_round_trip(tmp_path):
    cfg = TConfig()
    a = tsup.draw_spec_seeds(cfg)
    assert a == tsup.draw_spec_seeds(cfg)            # seeded by cfg.seed
    assert a != tsup.draw_spec_seeds(cfg.with_overrides(seed=1))
    assert len(a.obj) == cfg.obj_spn_repetitions
    assert all(0 <= s < 2 ** 31 - 1 for s in a.obj + a.bg)
    tsup.save_spec_seeds(str(tmp_path), a)
    assert tsup.run_spec_seeds(str(tmp_path), cfg) == a


def _setup(V=40, depth=2, S=3, I=4, R=3, seed=0, B=13):
    seeds = [int(s) for s in np.random.default_rng(seed).integers(
        0, 2 ** 31 - 1, R)]
    tspec = tspn.make_spec(seeds, V, depth, S, I, R, 0.1, 1.0)
    jspec = jspn.SpnSpec(V, depth, S, I, R, tspec.perms, tspec.scopes,
                         0.1, 1.0)
    jp = jspn.init_params(jax.random.key(seed), jspec)
    jp = {k: v * (3.0 if "logits" in k else 1.0) for k, v in jp.items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0, 1, (B, V)).astype(np.float32)
    w = rng.uniform(0, 1, (B, V)).astype(np.float32)
    w[:, :3] = 0.0                                   # exact marginalisation
    tp = {k: _t(v) for k, v in jp.items()}
    return tspec, jspec, tp, jp, x, w


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_spn_log_prob_matches_jax_and_oracle(depth):
    tspec, jspec, tp, jp, x, w = _setup(depth=depth, V=48)
    got = tspn.spn_log_prob(tspec, tp, _t(x), _t(w))
    np.testing.assert_allclose(got, jspn.spn_log_prob(jspec, jp, x, w), **TOL)
    np.testing.assert_allclose(
        got, jspn.spn_log_prob_numpy(jspec, jp, x, w), **TOL)
    np.testing.assert_allclose(tspn.spn_log_prob(tspec, tp, _t(x)),
                               jspn.spn_log_prob(jspec, jp, x), **TOL)


def test_init_params_shapes_and_scales():
    spec = tspn.make_spec([1, 2], 40, 2, 3, 4, 2)
    p = tspn.init_params(spec, torch.Generator().manual_seed(0))
    jp = jspn.init_params(jax.random.key(0), jspn.SpnSpec(
        40, 2, 3, 4, 2, spec.perms, spec.scopes, 0.05, 1.0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert 0 <= p["leaf_mu"].min() and p["leaf_mu"].max() <= 1
    assert 0.3 < p["leaf_raw_std"].std() < 0.7
    assert p["sum_logits_1"].abs().max() < 0.1


def test_fused_spn_on_cpu_matches_pallas_interpret():
    tspec, jspec, tp, jp, x, w = _setup(V=40, depth=2, B=13)
    want = pallas_spn.spn_log_prob_fused(jspec, jp, jnp.asarray(x),
                                         jnp.asarray(w), 8, True)
    got = fused_spn.spn_log_prob_fused(tspec, tp, _t(x), _t(w))
    np.testing.assert_allclose(got, want, **TOL)
    got1 = fused_spn.spn_log_prob_fused(tspec, tp, _t(x))
    np.testing.assert_allclose(
        got1, pallas_spn.spn_log_prob_fused(jspec, jp, jnp.asarray(x), None,
                                            8, True), **TOL)
    assert fused_spn.launch_kernel.launches == 0      # no kernel on the CPU


def test_fused_spn_gradient_is_the_plain_gradient_and_jaxs():
    tspec, jspec, tp, jp, x, w = _setup(V=40, depth=2, B=9)
    keys = fused_spn.param_keys(tspec)

    def grads(fn):
        leaves = [tp[k].clone().requires_grad_(True) for k in keys]
        xx, ww = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        out = fn(tspec, dict(zip(keys, leaves)), xx, ww)
        (out * torch.arange(1.0, 10.0)).sum().backward()
        return [l.grad for l in leaves] + [xx.grad, ww.grad]

    plain = grads(tspn.spn_log_prob)
    fused = grads(fused_spn.spn_log_prob_fused)
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
    jg = jax.grad(lambda p, xx, ww: jnp.sum(
        pallas_spn.spn_log_prob_fused(jspec, p, xx, ww, 8, True)
        * jnp.arange(1.0, 10.0)), argnums=(0, 1, 2))(jp, x, w)
    want = [jg[0][k] for k in keys] + [jg[1], jg[2]]
    for a, b in zip(fused, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_trained_spns_match_jax_at_full_width():
    """The committed object and background SPNs of ckpts/r4rp_bill_s32 on
    real-sized inputs (B=4)."""
    tc = ckpt.load_config("ckpts/r4rp_bill_s32")
    tp = ckpt.load_params("ckpts/r4rp_bill_s32", device="cpu")["supair"]
    jc = JConfig.from_json(tc.to_json())
    jspecs = jsup.make_specs(jax.random.key(jc.seed), jc)
    tspecs = tsup.make_specs(tc, jax_spec_seeds(jc))
    rng = np.random.default_rng(7)
    for name, js, ts in (("obj_spn", jspecs.obj, tspecs.obj),
                         ("bg_spn", jspecs.bg, tspecs.bg)):
        x = rng.uniform(0, 1, (4, js.num_vars)).astype(np.float32)
        w = rng.uniform(0, 1, (4, js.num_vars)).astype(np.float32)
        jp = {k: jnp.asarray(v.numpy()) for k, v in tp[name].items()}
        want = jspn.spn_log_prob(js, jp, x, w)
        np.testing.assert_allclose(
            fused_spn.spn_log_prob_fused(ts, tp[name], _t(x), _t(w)), want,
            rtol=1e-5, atol=1e-3, err_msg=name)
