"""The training objective of the port against `stove_tpu/models/stove.py::elbo`
and `stove_tpu/models/supair.py::elbo`: every `ElboOut` field, and the
gradient with respect to every parameter leaf, with the noise JAX draws
from its own keys handed to the port (tests/torch_parity.py).

* Trained weights (ckpts/r4rp_bill_s32, full width, seed-32 region
  graphs), B=4 windows of 8 rendered frames, through the kernel impls
  (`scan_impl=pallas likelihood_impl=pallas`, their plain versions here).
  `scan_impl=pallas` runs the scan's forward in bfloat16 on both sides
  (the JAX package's Pallas kernel in interpret mode,
  torch_parity.jax_scan_pallas_interpret) and its backward in float32.
* `debug_shrunk` random weights with overshoot_sample on, forward and
  gradients; the gradients through every kernel impl equal the plain
  impls' up to the order in which autograd adds a leaf's contributions
  (1e-6 of each leaf's largest entry), the scan's with its forward in
  float32 (the plumbing; its bfloat16 forward is held to JAX's above).
Tolerances: ELBO terms of ~10³ per window, rtol 1e-5 (atol 1e-3); the
overshoot loss (squared position errors ~1e-3) atol 1e-6; gradients to
1e-4 of each leaf's largest entry, mixture logits to 1e-4 of their
natural scale (see test_torch_supair.py).
"""

import jax
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models import stove as jstove
from stove_tpu.models import supair as jsup
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.train import checkpoint as ckpt
from stove_tpu_torch.ops import fused_scan
from torch_parity import (jax_elbo_noise, jax_scan_pallas_interpret,
                          jax_spec_seeds, jax_supair_noise,
                          straight_through_scan, to_jax)

RUN = "ckpts/r4rp_bill_s32"
KERNELS = dict(scan_impl="pallas", likelihood_impl="pallas")
FIELDS = ("loss", "elbo", "log_lik", "kl", "reward_loss", "overshoot_loss",
          "overshoot_reward_loss", "open_sigma_nll")


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(jc, B, key):
    ep = jdata.generate(jc.with_overrides(seq_len=jc.window), B,
                        jax.random.key(key))
    return np.asarray(jdata.normalize_frames(ep.frames))


def _check_out(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        tol = dict(rtol=0, atol=1e-6) if "overshoot" in name else \
            dict(rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(g.detach(), w, err_msg=name, **tol)
    for name in ("z", "z_mean", "kl"):
        np.testing.assert_allclose(getattr(got.inferred, name).detach(),
                                   getattr(want.inferred, name), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_trained_elbo_matches_jax():
    tc = ckpt.load_config(RUN).with_overrides(**KERNELS)
    jc = JConfig.from_json(ckpt.load_config(RUN).to_json())
    tp = ckpt.load_params(RUN, device="cpu")
    jp = to_jax(tp)
    frames = _frames(jc, 4, 21)
    key = jax.random.key(3)
    jspecs = jstove.make_specs(jax.random.key(jc.seed), jc)
    jcp = jc.with_overrides(scan_impl="pallas")
    with jax_scan_pallas_interpret():
        want = jax.jit(lambda p, f, k: jstove.elbo(
            p, jcp, jspecs, f, None, None, k))(jp, frames, key)
    got = tstove.elbo(tp, tc, tstove.make_specs(tc, tsup.run_spec_seeds(
        RUN, tc)), _t(frames), None, None, jax_elbo_noise(key, jc, 4, 8))
    _check_out(got, want)
    assert 1100 < float(got.elbo) < 1300                 # the trained regime


def _shrunk(**kw):
    jc = JConfig().debug_shrunk().with_overrides(
        num_obj=3, overshoot_k=3, overshoot_sample=True, window=6,
        reward_head=False, **kw)
    tc = TConfig.from_json(jc.to_json())
    jspecs = jstove.make_specs(jax.random.key(jc.seed), jc)
    tspecs = tstove.make_specs(tc, jax_spec_seeds(jc))
    jp = jstove.init_params(jax.random.key(1), jc, jspecs)
    jp["dynamics"]["out"][-1]["w"] = 0.05 * jax.random.normal(
        jax.random.key(5), jp["dynamics"]["out"][-1]["w"].shape)
    jp["supair"]["encoder"]["head"]["w"] = 30.0 * \
        jp["supair"]["encoder"]["head"]["w"]
    tp = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jc, tc, jspecs, tspecs, jp, tp, _frames(jc, 3, 8)


def test_shrunk_elbo_matches_jax():
    jc, tc, jspecs, tspecs, jp, tp, frames = _shrunk()
    key = jax.random.key(4)
    jcp = jc.with_overrides(scan_impl="pallas")
    with jax_scan_pallas_interpret():
        want = jax.jit(lambda p, f, k: jstove.elbo(
            p, jcp, jspecs, f, None, None, k))(jp, frames, key)
    noise = jax_elbo_noise(key, jc, 3, jc.window)
    assert noise.overshoot is not None
    got = tstove.elbo(tp, tc.with_overrides(**KERNELS), tspecs, _t(frames),
                      None, None, noise)
    _check_out(got, want)


def _grads(loss_fn, tp):
    leaves = [x.clone().requires_grad_(True) for x in tree.leaves(tp)]
    loss_fn(tree.unflatten(tp, leaves)).backward()
    return [x.grad for x in leaves]


def _check_grads(got, jgrads, tp, scale_logits):
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(want) == len(got)
    for (path, _), g, w in zip(tree.paths(tp), got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g
        atol = (1e-4 * scale_logits if "logits" in str(path[-1])
                else 1e-4 * max(float(np.abs(w).max()), 1e-3))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                   err_msg=str(path))


def test_elbo_gradient_matches_jax_grad():
    jc, tc, jspecs, tspecs, jp, tp, frames = _shrunk()
    key = jax.random.key(6)
    jcp = jc.with_overrides(scan_impl="pallas")
    with jax_scan_pallas_interpret():
        jg = jax.jit(jax.grad(lambda p: jstove.elbo(
            p, jcp, jspecs, frames, None, None, key).loss))(jp)
    noise = jax_elbo_noise(key, jc, 3, jc.window)
    got = _grads(lambda p: tstove.elbo(p, tc.with_overrides(**KERNELS),
                                       tspecs, _t(frames), None, None,
                                       noise).loss, tp)
    # the loss is −ELBO/T averaged over B windows: ∂/∂logit ≤ T·B/(T·B) = 1
    _check_grads(got, jg, tp, scale_logits=1.0)


def test_supair_elbo_gradient_matches_jax_grad():
    jc, tc, jspecs, tspecs, jp, tp, frames = _shrunk()
    flat = frames.reshape(-1, jc.img_size, jc.img_size)
    key = jax.random.key(7)
    jg = jax.jit(jax.grad(lambda p: -jsup.elbo(p, jc, jspecs.supair, flat,
                                               key)[0]))(jp["supair"])
    noise = jax_supair_noise(key, flat.shape[0], jc.num_obj)
    got = _grads(lambda p: -tsup.elbo(p, tc.with_overrides(**KERNELS),
                                      tspecs.supair, _t(flat), noise)[0],
                 tp["supair"])
    _check_grads(got, jg, tp["supair"], scale_logits=1.0)


@pytest.mark.parametrize("impls", [dict(scan_impl="pallas"),
                                   dict(spn_impl="pallas"),
                                   dict(likelihood_impl="pallas")],
                         ids=["scan", "spn", "likelihood"])
def test_kernel_impl_gradients_equal_plain_on_cpu(impls, monkeypatch):
    # the autograd function around each plain version against the plain
    # path; the scan's, whose forward is bf16 and backward the float32
    # VJP, against the plain scan built with those semantics without it
    jc, tc, jspecs, tspecs, jp, tp, frames = _shrunk()
    noise = jax_elbo_noise(jax.random.key(8), jc, 3, jc.window)

    def loss(cfg):
        return lambda p: tstove.elbo(p, cfg, tspecs, _t(frames), None, None,
                                     noise).loss

    got = _grads(loss(tc.with_overrides(**impls)), tp)
    if "scan_impl" in impls:
        monkeypatch.setattr(fused_scan, "scan_reference",
                            straight_through_scan(fused_scan.scan_reference))
    for a, b in zip(got, _grads(loss(tc), tp)):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
