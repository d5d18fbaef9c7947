"""SuPAIR likelihood and ELBO of the port against `stove_tpu/models/supair.py`
and `stove_tpu/ops/pallas_likelihood.py`.

* `supair.likelihood` at every ported impl (xla + dense SPN, xla + pallas
  SPN, pallas likelihood; on the CPU the last two run their plain versions
  through the autograd functions) against the JAX dense path, at full
  width on the trained weights of ckpts/r4rp_bill_s32 with the seed-32
  region graphs, on 6 rendered frames and boxes from the trained encoder.
* `fused_likelihood.likelihood_fused` against the Pallas kernel in
  interpret mode (tile 4) at `debug_shrunk` widths, with and without the
  overlap correction, and its gradient.
* `supair.elbo` with JAX's own noise.
Tolerances: log-likelihoods of ~10³ summed in another order, rtol 1e-5
(atol 2e-3); the shrunk random model, as tests/test_pallas.py holds the
Pallas kernel, rtol 2e-5, atol 2e-4; gradients to 1e-4 of each leaf's
largest entry (`_close_to_scale`), the mixture logits' as stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models import supair as jsup
from stove_tpu.ops.pallas_likelihood import likelihood_fused as jfused
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.ops import fused_likelihood, fused_spn
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_spec_seeds, jax_supair_noise, to_jax

RUN = "ckpts/r4rp_bill_s32"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def trained():
    tc = ckpt.load_config(RUN)
    tp = ckpt.load_params(RUN, device="cpu")["supair"]
    jc = JConfig.from_json(tc.to_json())
    jspecs = jsup.make_specs(jax.random.key(jc.seed), jc)
    tspecs = tsup.make_specs(tc, tsup.run_spec_seeds(RUN, tc))
    ep = jdata.generate(jc.with_overrides(seq_len=2), 3, jax.random.key(4))
    frames = np.asarray(jdata.normalize_frames(ep.frames)).reshape(6, 32, 32)
    jp = to_jax(tp)
    mean, std = jsup.encode(jp, jc, frames)
    boxes = np.asarray(mean + 0.3 * std * jax.random.normal(
        jax.random.key(5), mean.shape))
    return jc, tc, jspecs, tspecs, jp, tp, frames, boxes


@pytest.mark.parametrize("impl", [dict(spn_impl="dense"),
                                  dict(spn_impl="pallas"),
                                  dict(likelihood_impl="pallas")],
                         ids=["xla-dense", "xla-spn-pallas", "pallas"])
def test_trained_likelihood_matches_jax(trained, impl):
    jc, tc, jspecs, tspecs, jp, tp, frames, boxes = trained
    want = jsup.likelihood(jp, jc, jspecs, frames, boxes)
    got = tsup.likelihood(tp, tc.with_overrides(**impl), tspecs,
                          _t(frames), _t(boxes))
    assert float(np.min(want)) > 500                  # a trained model's scale
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)


def test_trained_supair_elbo_matches_jax(trained):
    jc, tc, jspecs, tspecs, jp, tp, frames, _ = trained
    key = jax.random.key(9)
    want, wdiag = jsup.elbo(jp, jc, jspecs, frames, key)
    got, gdiag = tsup.elbo(tp, tc.with_overrides(likelihood_impl="pallas"),
                           tspecs, _t(frames),
                           jax_supair_noise(key, 6, tc.num_obj))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    for k, v in wdiag.items():
        np.testing.assert_allclose(gdiag[k], v, rtol=1e-5, atol=2e-3,
                                   err_msg=k)


def _shrunk(**kw):
    jc = JConfig().debug_shrunk().with_overrides(num_obj=3, **kw)
    tc = TConfig.from_json(jc.to_json())
    jspecs = jsup.make_specs(jax.random.key(jc.seed), jc)
    tspecs = tsup.make_specs(tc, jax_spec_seeds(jc))
    jp = jsup.init_params(jax.random.key(1), jc, jspecs)
    B = 7
    frames = jax.random.uniform(jax.random.key(2), (B, jc.img_size,
                                                    jc.img_size))
    sxy = 0.2 + 0.2 * jax.random.uniform(jax.random.key(3), (B, 3, 2))
    txy = 0.8 * (jax.random.uniform(jax.random.key(4), (B, 3, 2)) * 2 - 1)
    boxes = jnp.concatenate([sxy, txy], axis=-1)
    tp = {k: (v if k == "encoder" else {n: _t(a) for n, a in v.items()})
          for k, v in jp.items() if k != "encoder"}
    return jc, tc, jspecs, tspecs, jp, tp, np.asarray(frames), \
        np.asarray(boxes)


@pytest.mark.parametrize("overlap", [True, False])
def test_fused_likelihood_on_cpu_matches_pallas_interpret(overlap):
    jc, tc, jspecs, tspecs, jp, tp, frames, boxes = _shrunk(
        overlap_correction=overlap)
    want = jfused(jc, jspecs, jp, jnp.asarray(frames), jnp.asarray(boxes),
                  tile=4, interpret=True)
    got = fused_likelihood.likelihood_fused(tc, tspecs, tp, _t(frames),
                                            _t(boxes))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    assert fused_likelihood.launch_kernel.launches == 0


def test_fused_likelihood_gradient_matches_jax():
    jc, tc, jspecs, tspecs, jp, tp, frames, boxes = _shrunk()
    w = np.arange(1.0, 8.0, dtype=np.float32)

    # the Pallas kernel's custom VJP is the dense path's, so jax.grad of
    # the dense likelihood is the reference gradient
    def jloss(p, b):
        return jnp.sum(jsup.likelihood(p, jc, jspecs, jnp.asarray(frames), b)
                       * w)

    jg_p, jg_b = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(boxes))
    leaves = {k: {n: a.clone().requires_grad_(True) for n, a in v.items()}
              for k, v in tp.items()}
    b = _t(boxes).requires_grad_(True)
    out = fused_likelihood.likelihood_fused(tc, tspecs, leaves, _t(frames), b)
    (out * _t(w)).sum().backward()
    _close_to_scale(b.grad, jg_b, "boxes", 1e-4)
    for k, v in leaves.items():
        for n, a in v.items():
            if "logits" in n:
                # ∂/∂logit = Σ_b w_b (responsibility − weight), each term in
                # [−w_b, w_b]; responsibilities are softmaxes over
                # activations of size |log p| ~ 10³ and carry float32 errors
                # up to ~1e-4, so the bound is 1e-4 · Σ_b w_b
                np.testing.assert_allclose(a.grad, jg_p[k][n], rtol=0,
                                           atol=1e-4 * float(w.sum()),
                                           err_msg=f"{k}.{n}")
            else:
                _close_to_scale(a.grad, jg_p[k][n], f"{k}.{n}", 1e-4)


def _close_to_scale(got, want, name, rel):
    """max |got − want| ≤ rel · max |want|: a gradient entry is a sum over
    pixels of terms that cancel, so its float32 error scales with the
    largest entries, not with its own size."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=name)


def test_unported_options_raise():
    """Where the JAX package raises, the port raises the same error before
    anything runs: the fused likelihood with the image-space claim weights
    (supair.py:149-154), an SPN impl it does not know.  compute_dtype=
    bfloat16, once refused here, builds (tests/test_torch_compute_bf16.py
    holds it to the JAX package)."""
    jc, tc, jspecs, tspecs, jp, tp, frames, boxes = _shrunk()
    from stove_tpu_torch.models.bundle import StoveModel
    assert StoveModel(tc.with_overrides(compute_dtype="bfloat16"),
                      device="cpu").precision == "dense_bf16"
    with pytest.raises(ValueError, match="unknown spn_impl"):
        tsup.likelihood(tp, tc.with_overrides(spn_impl="sparse"), tspecs,
                        _t(frames), _t(boxes))
    with pytest.raises(ValueError, match="overlap_impl='patch'"):
        tsup.likelihood(tp, tc.with_overrides(overlap_impl="image",
                                              likelihood_impl="pallas"),
                        tspecs, _t(frames), _t(boxes))
    assert fused_spn.launch_kernel.launches == 0
