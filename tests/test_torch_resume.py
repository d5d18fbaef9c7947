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
import pytest
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


@pytest.mark.slow
def test_bfloat16_matmuls_do_not_explain_the_logged_kl(capsys):
    """Candidate 1 for the gap between the run's log (kl -5.9) and the
    reference's float32 kl at the same weights: the TPU's default
    precision, one bfloat16 pass per matmul.  On the CPU,
    jax.default_matmul_precision("bfloat16") changes nothing (XLA's CPU
    dots ignore it: asserted), so the reference's `stove.elbo` is
    evaluated a third time with every dot and convolution operand rounded
    to bfloat16 (f32 accumulation, the MXU's single pass), by wrapping
    jax's own dot_general and conv_general_dilated for this test only.
    The windows, noise and weights are test_reference_float32_elbo_on_
    its_training_corpus's.  Finding: kl moves by less than 0.5, not the
    ~3 toward -5.9 that would explain the log."""
    from jax._src.lax import convolution as jconv
    from jax._src.lax import lax as jlax

    jc = jckpt.load_config(RUN)
    jm = JModel(jc)
    _, loaded = jckpt.restore(RUN, {"params": jm.init_params()})
    ep = jdata.generate(jc, 64, jax.random.key(jc.seed))
    batches = [jdata.sample_windows(ep, jc, jax.random.key(100 + i), 32)
               for i in range(4)]

    def terms():
        jax.clear_caches()
        rows = [jm.elbo(loaded["params"], b["frames"], None, None,
                        jax.random.key(200 + i))
                for i, b in enumerate(batches)]
        return np.array([[float(o.elbo), float(o.kl)] for o in rows])

    f32 = terms()
    with jax.default_matmul_precision("bfloat16"):
        flag = terms()
    real_dot, real_conv = jlax.dot_general, jconv.conv_general_dilated

    def bf16(x):
        return (x.astype(jax.numpy.bfloat16).astype(x.dtype)
                if x.dtype == jax.numpy.float32 else x)

    jlax.dot_general = lambda a, b, *r, **k: real_dot(bf16(a), bf16(b), *r,
                                                      **k)
    jconv.conv_general_dilated = lambda a, b, *r, **k: real_conv(
        bf16(a), bf16(b), *r, **k)
    try:
        rounded = terms()
    finally:
        jlax.dot_general, jconv.conv_general_dilated = real_dot, real_conv
        jax.clear_caches()
    with capsys.disabled():
        for name, v in (("float32", f32), ("precision flag", flag),
                        ("bf16 operands", rounded)):
            print(f"\n[bf16] {name}: elbo {v[:, 0].mean():.2f} kl "
                  f"{v[:, 1].mean():.3f}", end="")
        print()
    np.testing.assert_array_equal(flag, f32)
    assert abs(rounded[:, 1].mean() - f32[:, 1].mean()) < 0.5
    assert rounded[:, 1].mean() < -7.5
