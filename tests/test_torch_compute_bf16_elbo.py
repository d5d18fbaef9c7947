"""compute_dtype=bfloat16 of the port's training objective and eval on
the CPU, against the JAX package at compute_dtype=bfloat16: the ELBO's
loss and gradients, and the JAX package's bf16 eval bands that
chip_smoke.py phase (32) holds the card to.  The modules are held in
tests/test_torch_compute_bf16.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models import stove as jstove
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.train import evaluate as jeval
import chip_smoke
from stove_tpu_torch import main as tmain
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import (jax_elbo_noise, jax_scan_pallas_interpret,
                          jax_spec_seeds, to_jax)

RUNS = {"billiards": "ckpts/r4rp_bill_s32", "gravity": "ckpts/r4rp_grav_s32"}
BF16 = dict(compute_dtype="bfloat16")
F32 = dict(compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ the ELBO

ELBO_FACTOR = 0.1     # port - JAX bf16 against JAX bf16 - f32


def _shrunk_elbo(scan_impl):
    """debug_shrunk random weights (tests/test_torch_elbo.py's, with the
    preset's space-to-depth encoder), 3 windows of 6 frames, JAX's noise
    from jax.random.key(4): JAX's loss and gradients at bf16 (the pallas
    scan in interpret mode, its backward `_scan_xla` at cfg), and the
    port's configs and weights."""
    jc = JConfig().debug_shrunk().with_overrides(
        num_obj=3, overshoot_k=3, overshoot_sample=True, window=6,
        reward_head=False, encoder_space_to_depth=2, scan_impl=scan_impl,
        **BF16)
    jspecs = jstove.make_specs(jax.random.key(jc.seed), jc)
    jp = jstove.init_params(jax.random.key(1), jc, jspecs)
    jp["dynamics"]["out"][-1]["w"] = 0.05 * jax.random.normal(
        jax.random.key(5), jp["dynamics"]["out"][-1]["w"].shape)
    jp["supair"]["encoder"]["head"]["w"] = 30.0 * \
        jp["supair"]["encoder"]["head"]["w"]
    ep = jdata.generate(jc.with_overrides(seq_len=jc.window), 3,
                        jax.random.key(8))
    frames = np.asarray(jdata.normalize_frames(ep.frames))
    key = jax.random.key(4)

    def side(c):
        with jax_scan_pallas_interpret():
            return jax.jit(jax.value_and_grad(lambda p, f, k: jstove.elbo(
                p, c, jspecs, f, None, None, k).loss))(jp, frames, key)

    tc = Config.from_json(jc.to_json())
    tp = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return (tc, tstove.make_specs(tc, jax_spec_seeds(jc)), tp, frames,
            jax_elbo_noise(key, jc, 3, jc.window), side(jc))


def _port_elbo(tc, specs, tp, frames, noise):
    """The port's loss and gradient leaves."""
    lv = [x.clone().requires_grad_(True) for x in tree.leaves(tp)]
    out = tstove.elbo(tree.unflatten(tp, lv), tc, specs, _t(frames), None,
                      None, noise)
    return (float(out.loss.detach()),
            torch.autograd.grad(out.loss, lv, allow_unused=True))


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_elbo_loss_and_grads_match_jax_bf16(scan_impl):
    """`elbo` at compute_dtype=bfloat16 against JAX's: the loss and the
    gradient of every encoder and dynamics leaf closer to JAX's bf16 ones
    than ELBO_FACTOR times the bf16 - f32 distance (the largest entry of
    each leaf; the f32 side is the port's own float32 ELBO with the xla
    scan, which tests/test_torch_elbo.py holds to JAX's to ~1e-5 of a
    leaf, far inside these distances).  Measured: the loss at
    ~2e-4 of it, the gradients at most ~0.012.  With scan_impl=pallas both
    forwards run the TPU kernel's bf16 variant and both backwards the VJP
    of the plain scan at compute_dtype.  The SPN leaves, which
    compute_dtype leaves in float32, are held in float32 by
    tests/test_torch_elbo.py.

    On the trained billiards weights the gradients cannot be held so: JAX's
    own bf16 gradients differ from its f32 ones by 10-50% of each leaf's
    largest entry, and the port's from JAX's bf16 ones by as much (ratio
    0.92 in the median), where the two f32 gradients agree to 1e-5: the
    gradient is a small difference of large terms there, so a single bf16
    rounding that flips between the two sums' orders moves it by tenths
    (PERF.md)."""
    tc, specs, tp, frames, noise, (jl, jg) = _shrunk_elbo(scan_impl)
    loss, got = _port_elbo(tc, specs, tp, frames, noise)
    fl, fg = _port_elbo(tc.with_overrides(scan_impl="xla", **F32), specs,
                        tp, frames, noise)
    loss_ratio = abs(loss - float(jl)) / abs(float(jl) - fl)
    ratios = []
    for (path, w), g, f in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                               got, fg):
        if "spn" in jax.tree_util.keystr(path):
            continue
        w, f = np.asarray(w), f.numpy()
        ratios.append(np.abs(g.numpy() - w).max() / np.abs(w - f).max())
    print(f"\n[elbo bf16 {scan_impl}] loss ratio {loss_ratio:.3e}; "
          f"gradient ratios max {max(ratios):.3e} median "
          f"{np.median(ratios):.3e} over {len(ratios)} leaves")
    assert loss_ratio <= ELBO_FACTOR
    assert max(ratios) <= ELBO_FACTOR


@pytest.mark.parametrize("name", ["billiards", "gravity"])
def test_bf16_eval_band_from_the_jax_package(name, tmp_path, capsys):
    """mode=eval of the trained model at compute_dtype=bfloat16: the JAX
    package's mse_final at bf16 on the port's test corpus over 16
    posterior draws sets chip_smoke.BF16_EVAL_BANDS[name] (their range,
    widened by half its width on each side, as the float32 bands were
    made); the port's own CPU mode=eval at bf16 lies in the band, as the
    card's must in phase (32)."""
    run = RUNS[name]
    cfg = ckpt.load_config(run).with_overrides(**BF16)
    model = StoveModel.from_run(run, cfg=cfg, device="cpu")
    jc = JConfig.from_json(cfg.to_json())
    tep = tdata.split(cfg, "test")
    jep = jdata.Episode(*(jnp.asarray(x.numpy()) for x in tep))
    jmodel = JModel(jc)
    metric = jax.jit(lambda p, k: jeval.rollout_metrics(
        jmodel, p, jep, k)["mse_final"])
    draws = np.array([float(metric(to_jax(model.params), jax.random.key(s)))
                      for s in range(16)])
    port = float(tmain.run_eval(cfg.with_overrides(
        restore=run, data_dir=str(tmp_path)), "cpu")["mse_final"])
    lo, hi = chip_smoke.BF16_EVAL_BANDS[name]["mse_final"]
    a, b = draws.min(), draws.max()
    with capsys.disabled():
        print(f"\n[bf16 eval band] {name} jax keys 0-15: mse_final min "
              f"{a:.6g} max {b:.6g}; port cpu {port:.6g}")
    assert lo <= a - (b - a) / 2 and b + (b - a) / 2 <= hi, (a, b, lo, hi)
    assert lo <= port <= hi, (port, lo, hi)
