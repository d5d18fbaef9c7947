"""Training the avoidance model on the CPU: what resuming
ckpts/r4a_dense_s2 should give, and the ELBO with actions and rewards
through the scan kernel's dispatch.

The band: the JAX package's float32 ELBO terms at the restored weights on
windows of the port's training corpus (split(cfg, "train") at 64
sequences, with their actions and rewards), 8 batches of 32 windows under
JAX's noise; chip_smoke.AVOID_RESUME_BAND is their range widened by half
its width.  The port equals JAX on the same windows and noise (rtol 1e-5,
as tests/test_torch_resume.py).  The run's own log (elbo 879.3, kl -8.27,
reward_loss 0.217 at step 8000) was taken on another corpus and is
context only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models.bundle import StoveModel as JModel
import chip_smoke
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_elbo_noise, to_jax

RUN = "ckpts/r4a_dense_s2"
KEYS = ("elbo", "kl", "reward_loss", "overshoot_loss",
        "overshoot_reward_loss")


def test_resume_band_from_the_jax_package(capsys):
    cfg = ckpt.load_config(RUN)
    model = StoveModel.from_run(RUN, device="cpu")
    jparams = to_jax(model.params)
    ep = tdata.split(cfg.with_overrides(num_train=64), "train")
    jm = JModel(JConfig.from_json(cfg.to_json()))
    elbo = jax.jit(jm.elbo)
    g = torch.Generator().manual_seed(100)
    want, got = [], []
    for i in range(8):
        b = tdata.sample_windows(ep, cfg, g, 32)
        key = jax.random.key(200 + i)
        o = elbo(jparams, jnp.asarray(b["frames"].numpy()),
                 jnp.asarray(b["actions"].numpy(), jnp.int32),
                 jnp.asarray(b["rewards"].numpy()), key)
        want.append([float(getattr(o, k)) for k in KEYS])
        if i < 2:
            with torch.no_grad():
                t = model.elbo(model.params, b["frames"], b["actions"],
                               b["rewards"],
                               jax_elbo_noise(key, cfg, 32, cfg.window))
            got.append([float(getattr(t, k)) for k in KEYS])
    want = np.array(want)
    with capsys.disabled():
        for k, v in zip(KEYS, want.T):
            print(f"\n[avoid resume band] jax float32, 8 x 32 windows: {k} "
                  f"min {v.min():.6g} max {v.max():.6g} mean {v.mean():.6g}",
                  end="")
        print()
    np.testing.assert_allclose(np.array(got), want[:2], rtol=1e-5, atol=1e-5)
    for k, v in zip(KEYS, want.T):
        if k not in chip_smoke.AVOID_RESUME_BAND:
            continue
        lo, hi = chip_smoke.AVOID_RESUME_BAND[k]
        a, b = v.min(), v.max()
        assert lo <= a - (b - a) / 2 and b + (b - a) / 2 <= hi, \
            (k, a, b, (lo, hi))


def test_elbo_gradient_with_actions_through_the_scan_dispatch():
    """The ELBO of an action-conditioned model with its reward loss, at
    debug_shrunk widths: scan_impl="pallas" (on the CPU the plain loop
    through the kernel's autograd function) gives the plain loop's loss
    bit for bit and its gradients to 1e-6 of each leaf's largest entry
    (the scan's gradient is added to the overshoot's in another order),
    the reward head's and the action rows' gradients nonzero."""
    cfg = Config().debug_shrunk().with_overrides(
        task="avoidance", action_conditioned=True, reward_head=True,
        seq_len=12, window=8, overshoot_k=3)
    model = StoveModel(cfg, device="cpu")
    ep = tdata.generate(cfg, 4, torch.Generator().manual_seed(1))
    b = tdata.sample_windows(ep, cfg, torch.Generator().manual_seed(2), 4)
    noise = tstove.draw_elbo_noise(cfg, 4, cfg.window,
                                   torch.Generator().manual_seed(3), "cpu")

    def run(impl):
        leaves = [x.clone().requires_grad_(True)
                  for x in tree.leaves(model.params)]
        params = tree.unflatten(model.params, leaves)
        out = tstove.elbo(params, cfg.with_overrides(scan_impl=impl),
                          model.specs, b["frames"], b["actions"],
                          b["rewards"], noise)
        return out, torch.autograd.grad(out.loss, leaves, allow_unused=True)

    (o_k, g_k), (o_p, g_p) = run("pallas"), run("xla")
    assert float(o_k.reward_loss.detach()) > 0
    assert float(o_k.overshoot_reward_loss.detach()) > 0
    for k in ("loss", "elbo", "kl", "reward_loss"):
        assert torch.equal(getattr(o_k, k), getattr(o_p, k)), k
    named = dict(zip((tree.keystr(p) for p, _ in tree.paths(model.params)),
                     zip(g_k, g_p)))
    for a, b_ in zip(g_k, g_p):
        assert (a is None) == (b_ is None)
        if a is not None:
            torch.testing.assert_close(
                a, b_, rtol=0, atol=1e-6 * max(1.0, float(b_.abs().max())))
    reward = [v[0] for k, v in named.items() if "reward" in k
              and not k.endswith("['reward_att'][2]['b']")]   # softmax shift
    assert reward and all(g is not None and g.abs().max() > 0
                          for g in reward)
    embed0 = named[[k for k in named if "embed" in k and "[0]" in k
                    and k.endswith("['w']")][0]][0]
    assert embed0[cfg.full_state_dim:].abs().max() > 0   # action rows
