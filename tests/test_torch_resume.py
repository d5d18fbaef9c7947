"""What resuming ckpts/r4rp_bill_s32 should give: the JAX package's own
ELBO terms at the restored weights, in float32 on the CPU, on windows of
its own training corpus (the first sequences of `generate(cfg, 1000,
key(seed))`, which `ensure_dataset` makes for the run), and the port's on
the same windows and noise.

The run's metrics.jsonl logs elbo 1216.9-1227.1 and kl -6.26 to -5.70 over
its last 40 steps, but the reference evaluated here gives about 1202 and
-9 (printed with -s), so chip_smoke.py phase (10) holds the port's resume
to the reference's own value.  Bands: a batch of 32-64 windows spreads by
~9 in elbo and ~1.5 in kl, so the mean of 4 x 32 windows is held to
[1190, 1215] and kl to [-10.5, -7.5]; the port equals the reference on
the same inputs (rtol 1e-5, as in test_torch_elbo.py).
"""

import jax
import numpy as np
import torch

from stove_tpu.envs import data as jdata
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.train import checkpoint as jckpt
from stove_tpu_torch.models.bundle import StoveModel
from torch_parity import jax_elbo_noise

RUN = "ckpts/r4rp_bill_s32"


def test_reference_float32_elbo_on_its_training_corpus():
    jc = jckpt.load_config(RUN)
    jm = JModel(jc)
    _, loaded = jckpt.restore(RUN, {"params": jm.init_params()})
    ep = jdata.generate(jc, 64, jax.random.key(jc.seed))
    tm = StoveModel.from_run(RUN, device="cpu")
    got, want = [], []
    for i in range(4):
        b = jdata.sample_windows(ep, jc, jax.random.key(100 + i), 32)
        key = jax.random.key(200 + i)
        o = jm.elbo(loaded["params"], b["frames"], None, None, key)
        want.append((float(o.elbo), float(o.kl), float(o.overshoot_loss)))
        with torch.no_grad():
            t = tm.elbo(tm.params, torch.from_numpy(np.array(b["frames"])),
                        None, None, jax_elbo_noise(key, tm.cfg, 32, jc.window))
        got.append((float(t.elbo), float(t.kl), float(t.overshoot_loss)))
    want, got = np.array(want), np.array(got)
    elbo, kl, over = want.mean(0)
    print(f"reference, float32, {len(want)} x 32 windows: elbo {elbo:.2f} "
          f"kl {kl:.3f} overshoot {over:.5f}")
    assert 1190.0 <= elbo <= 1215.0, elbo
    assert -10.5 <= kl <= -7.5, kl
    assert over < 0.02, over
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
