"""mode=eval of ckpts/r4rp_grav_s32 on the CPU against the JAX package:
the port equals it under the posterior noise JAX draws (1e-4 relative,
as tests/test_torch_avoidance.py), and the JAX package's float32 metrics
on the port's test corpus over 16 posterior draws set the band that
chip_smoke.py phase (21) holds the card to.  The rest of the gravity
slice is in tests/test_torch_gravity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.train import evaluate as jeval
import chip_smoke
from stove_tpu_torch import main as tmain
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.train import checkpoint as ckpt
from stove_tpu_torch.train import evaluate as teval
from torch_parity import jax_infer_noise, to_jax

RUN = "ckpts/r4rp_grav_s32"


@pytest.fixture(scope="module")
def run():
    cfg = ckpt.load_config(RUN)
    model = StoveModel.from_run(RUN, device="cpu")
    return cfg, model, to_jax(model.params)


@pytest.fixture(scope="module")
def eval_corpus(run):
    cfg, _, _ = run
    tep = tdata.split(cfg, "test")
    jcfg = JConfig.from_json(cfg.to_json())
    jep = jdata.Episode(*(jnp.asarray(x.numpy()) for x in tep))
    jmodel = JModel(jcfg)

    @jax.jit
    def metrics(p, k):
        k1, k2 = jax.random.split(k)
        m = jeval.rollout_metrics(jmodel, p, jep, k1)
        lh = jeval.longhorizon_metrics(jmodel, p, jep, k2, t_pred=80)
        return {"mse_final": m["mse_final"], "detect_mse": m["detect_mse"],
                "longhorizon_speed_ratio": lh["speed_ratio"]}

    return tep, jcfg, metrics


def test_eval_matches_jax_on_its_noise(run, eval_corpus, capsys):
    """mode=eval's metrics of the mean path under the posterior noise that
    jax.random.key(0) draws: the port equals the JAX package (1e-4)."""
    cfg, model, jparams = run
    tep, jcfg, metrics = eval_corpus
    key = jax.random.key(0)
    want = metrics(jparams, key)
    k1, k2 = jax.random.split(key)
    got = teval.rollout_metrics(model, tep, noise=jax_infer_noise(
        jax.random.split(k1)[0], jcfg, cfg.eval_batch, cfg.window))
    lh = teval.longhorizon_metrics(model, tep, t_pred=80, noise=jax_infer_noise(
        jax.random.split(k2)[0], jcfg, 32, cfg.window))
    got = {"mse_final": got["mse_final"], "detect_mse": got["detect_mse"],
           "longhorizon_speed_ratio": lh["speed_ratio"]}
    with capsys.disabled():
        print("\n[same noise] jax key 0, port / jax - 1: " + " ".join(
            f"{k} {float(got[k]) / float(want[k]) - 1:.2e}" for k in want))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def test_eval_band_from_the_jax_package(run, eval_corpus, capsys):
    """The JAX package's float32 metrics on the port's test corpus over 16
    posterior draws set chip_smoke.GRAV_EVAL_BAND (their range, widened by
    half its width); the port's own CPU mode=eval, one more draw of the
    same function (test_eval_matches_jax_on_its_noise), lies in the band,
    as the card's must."""
    cfg, _, jparams = run
    _, _, metrics = eval_corpus
    band = chip_smoke.GRAV_EVAL_BAND
    rows = [{k: float(v) for k, v in metrics(jparams,
                                             jax.random.key(s)).items()}
            for s in range(16)]
    port = tmain.run_eval(cfg.with_overrides(restore=RUN), "cpu")
    with capsys.disabled():
        for k in band:
            v = np.array([r[k] for r in rows])
            print(f"\n[grav eval band] jax keys 0-15: {k} min {v.min():.6g} "
                  f"max {v.max():.6g} mean {v.mean():.6g} std {v.std():.3g}; "
                  f"port cpu {float(port[k]):.6g}", end="")
        print()
    for k, (lo, hi) in band.items():
        a = min(r[k] for r in rows)
        b = max(r[k] for r in rows)
        assert lo <= a - (b - a) / 2 and b + (b - a) / 2 <= hi, \
            (k, a, b, (lo, hi))
        assert lo <= float(port[k]) <= hi, (k, float(port[k]), lo, hi)
