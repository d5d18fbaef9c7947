"""The SuPAIR settings `spn_impl="matmul"` and `overlap_impl="image"` of the
port against `stove_tpu/models/spn.py::spn_log_prob_matmul` and the
image-space branch of `stove_tpu/models/supair.py::likelihood`.

* `spn_log_prob_matmul` on the trained SPNs of ckpts/r4rp_bill_s32 (both
  shapes, full width) and on a shrunk random one, against JAX's: |err| ≤
  1e-5 · max(|log p|, 100), the SPN card tests' limit; its gradient
  against the port's dense `spn_log_prob` to 1e-4 of each leaf's largest
  entry.
* The likelihood with the image-space claim weights, against JAX's, on
  overlapping boxes (and on two coinciding ones, where the running max
  ties): the value to 1e-5 relative (floor 100), the gradients with
  respect to the boxes and the SPN parameters to 1e-4 of each leaf's
  largest entry (`_close_grad`).  The mixture logits' gradients, sums
  over the samples of c_b·(responsibility − weight) with each term in
  [−c_b, c_b] whatever the gradient's size, to 1e-4·Σ_b c_b, as
  tests/test_torch_supair.py holds them.
* `likelihood_impl="pallas"` with `overlap_impl="image"` raises the JAX
  package's ValueError before anything runs.
Inputs and random parameters come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import spn as jspn
from stove_tpu.models import supair as jsup
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import spn as tspn
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.ops import fused_likelihood
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_spec_seeds

RUN = "ckpts/r4rp_bill_s32"


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_rel(got, want, floor=100.0, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), floor)
    assert err.max() <= rel, err.max()


def _close_grad(got, want, name, csum):
    """max |got − want| ≤ 1e-4 · max |want| (a gradient entry is a sum of
    terms that cancel: its float32 error scales with the largest); for
    mixture logits 1e-4 · csum, csum the sum of the loss's weights."""
    want = np.asarray(want)
    atol = 1e-4 * (csum if "logits" in name else float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=name)


def _np_spn_params(spec, rng):
    """numpy draws in the shapes of `spn.init_params`, as it draws them:
    leaf means U(0, 1), raw stds 0.5·N(0, 1), logits 0.01·N(0, 1)."""
    shapes = {k: v.shape for k, v in tspn.init_params(
        spec, torch.Generator().manual_seed(0)).items()}
    scale = {"leaf_raw_std": 0.5}
    return {k: (rng.uniform(size=s) if k == "leaf_mu" else
                scale.get(k, 0.01) * rng.standard_normal(s)
                ).astype(np.float32) for k, s in shapes.items()}


def _shrunk_specs(**kw):
    jc = JConfig().debug_shrunk().with_overrides(num_obj=3, **kw)
    tc = TConfig.from_json(jc.to_json())
    return (jc, tc, jsup.make_specs(jax.random.key(jc.seed), jc),
            tsup.make_specs(tc, jax_spec_seeds(jc)))


@pytest.fixture(scope="module")
def trained():
    tc = ckpt.load_config(RUN)
    tp = ckpt.load_params(RUN, device="cpu")["supair"]
    jc = JConfig.from_json(tc.to_json())
    return (jc, tc, jsup.make_specs(jax.random.key(jc.seed), jc),
            tsup.make_specs(tc, tsup.run_spec_seeds(RUN, tc)),
            {k: {n: np.asarray(a) for n, a in v.items()}
             for k, v in tp.items() if k != "encoder"})


def _spn_cases(trained):
    jc, tc, jspecs, tspecs, tp = trained
    rng = np.random.default_rng(0)
    cases = [(jspecs.obj, tspecs.obj, tp["obj_spn"]),
             (jspecs.bg, tspecs.bg, tp["bg_spn"])]
    _, _, sj, st = _shrunk_specs()
    cases.append((sj.bg, st.bg, _np_spn_params(st.bg, rng)))
    return cases


@pytest.mark.parametrize("case", [0, 1, 2], ids=["obj", "bg", "shrunk"])
def test_spn_matmul_matches_jax(trained, case):
    jspec, tspec, p = _spn_cases(trained)[case]
    rng = np.random.default_rng(10 + case)
    x = rng.uniform(size=(8, tspec.num_vars)).astype(np.float32)
    w = rng.uniform(size=(8, tspec.num_vars)).astype(np.float32)
    want = jspn.spn_log_prob_matmul(jspec, {k: jnp.asarray(v)
                                            for k, v in p.items()},
                                    jnp.asarray(x), jnp.asarray(w))
    got = tspn.spn_log_prob_matmul(tspec, {k: _t(v) for k, v in p.items()},
                                   _t(x), _t(w))
    _close_rel(got, want)
    unweighted = jspn.spn_log_prob_matmul(
        jspec, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _close_rel(tspn.spn_log_prob_matmul(tspec, {k: _t(v) for k, v in
                                                p.items()}, _t(x)),
               unweighted)


@pytest.mark.parametrize("case", [0, 2], ids=["obj", "shrunk"])
def test_spn_matmul_gradient_matches_dense(trained, case):
    """Parameters, inputs and weights: the matmul form's gradient equals
    the dense form's (one function, another summation order)."""
    _, tspec, p = _spn_cases(trained)[case]
    rng = np.random.default_rng(20 + case)
    x = rng.uniform(size=(8, tspec.num_vars)).astype(np.float32)
    w = rng.uniform(size=(8, tspec.num_vars)).astype(np.float32)
    c = rng.uniform(1.0, 2.0, size=8).astype(np.float32)
    grads = []
    for fn in (tspn.spn_log_prob, tspn.spn_log_prob_matmul):
        leaves = {k: _t(v).requires_grad_(True) for k, v in p.items()}
        xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        (fn(tspec, leaves, xt, wt) * _t(c)).sum().backward()
        grads.append({"x": xt.grad, "w": wt.grad,
                      **{k: v.grad for k, v in leaves.items()}})
    dense, matmul = grads
    for k in dense:
        _close_grad(matmul[k], dense[k], k, float(c.sum()))


def _overlapping_boxes(rng, B, coincide=False):
    """(B, 3, 4) boxes, objects 1 and 2 centred within 0.15 of object 0 so
    that their coverages overlap; with `coincide`, object 2 equals object
    1 in every row (the running max ties on their whole masks)."""
    s = rng.uniform(0.2, 0.35, size=(B, 3, 2))
    t0 = rng.uniform(-0.5, 0.5, size=(B, 1, 2))
    t = np.concatenate([t0, t0 + rng.uniform(-0.15, 0.15, size=(B, 2, 2))],
                       1)
    boxes = np.concatenate([s, t], -1).astype(np.float32)
    if coincide:
        boxes[:, 2] = boxes[:, 1]
    return boxes


@pytest.mark.parametrize("spn_impl", ["dense", "matmul"])
@pytest.mark.parametrize("coincide", [False, True],
                         ids=["overlapping", "coinciding"])
def test_image_claims_likelihood_and_gradient_match_jax(spn_impl, coincide):
    jc, tc, jspecs, tspecs = _shrunk_specs(overlap_impl="image",
                                           spn_impl=spn_impl)
    rng = np.random.default_rng(30 + coincide)
    p = {"obj_spn": _np_spn_params(tspecs.obj, rng),
         "bg_spn": _np_spn_params(tspecs.bg, rng)}
    B = 6
    frames = rng.uniform(size=(B, 32, 32)).astype(np.float32)
    boxes = _overlapping_boxes(rng, B, coincide)
    wts = rng.uniform(1.0, 2.0, size=B).astype(np.float32)

    def jloss(prm, b):
        return jnp.sum(jsup.likelihood(prm, jc, jspecs, jnp.asarray(frames),
                                       b) * wts)

    jprm = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in p.items()}
    want = jsup.likelihood(jprm, jc, jspecs, jnp.asarray(frames),
                           jnp.asarray(boxes))
    jg_p, jg_b = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jprm, jnp.asarray(boxes))
    leaves = {k: {n: _t(a).requires_grad_(True) for n, a in v.items()}
              for k, v in p.items()}
    b = _t(boxes).requires_grad_(True)
    got = tsup.likelihood(leaves, tc, tspecs, _t(frames), b)
    _close_rel(got.detach(), want)
    (got * _t(wts)).sum().backward()
    _close_grad(b.grad, jg_b, "boxes", float(wts.sum()))
    for k, v in leaves.items():
        for n, a in v.items():
            _close_grad(a.grad, jg_p[k][n], f"{k}.{n}", float(wts.sum()))


def test_image_claims_differ_from_patch_claims():
    """The setting is read: on overlapping boxes the image-space claim
    weights give another likelihood than the patch-space ones (the two
    agree only up to mask interpolation)."""
    _, tc, _, tspecs = _shrunk_specs()
    rng = np.random.default_rng(40)
    p = {"obj_spn": {k: _t(v) for k, v in
                     _np_spn_params(tspecs.obj, rng).items()},
         "bg_spn": {k: _t(v) for k, v in
                    _np_spn_params(tspecs.bg, rng).items()}}
    frames = _t(rng.uniform(size=(4, 32, 32)).astype(np.float32))
    boxes = _t(_overlapping_boxes(rng, 4))
    patch = tsup.likelihood(p, tc, tspecs, frames, boxes)
    image = tsup.likelihood(p, tc.with_overrides(overlap_impl="image"),
                            tspecs, frames, boxes)
    assert (patch - image).abs().max().item() > 1e-3


def test_fused_likelihood_refuses_image_claims(monkeypatch):
    """`likelihood_impl="pallas"` has the patch-space claim weights only:
    with `overlap_impl="image"` (overlap correction on, O > 1) the port
    raises the JAX package's ValueError (supair.py:149-154) before it
    packs or launches anything; without the correction, or with one
    object, the setting is not read and nothing raises."""
    _, tc, _, tspecs = _shrunk_specs()
    rng = np.random.default_rng(50)
    p = {k: {n: _t(a) for n, a in _np_spn_params(s, rng).items()}
         for k, s in (("obj_spn", tspecs.obj), ("bg_spn", tspecs.bg))}
    frames = _t(rng.uniform(size=(2, 32, 32)).astype(np.float32))
    boxes = _t(_overlapping_boxes(rng, 2))
    cfg = tc.with_overrides(likelihood_impl="pallas", overlap_impl="image")
    real = fused_likelihood.likelihood_reference

    def must_not_run(*a, **k):
        raise AssertionError("the likelihood ran")

    monkeypatch.setattr(fused_likelihood, "likelihood_reference",
                        must_not_run)
    with pytest.raises(ValueError, match="set overlap_impl='patch'"):
        tsup.likelihood(p, cfg, tspecs, frames, boxes)
    monkeypatch.setattr(fused_likelihood, "likelihood_reference", real)
    out = tsup.likelihood(p, cfg.with_overrides(overlap_correction=False),
                          tspecs, frames, boxes)
    assert torch.isfinite(out).all()
    one = tsup.likelihood(p, cfg, tspecs, frames, boxes[:, :1])
    assert torch.isfinite(one).all()
