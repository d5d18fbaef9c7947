"""The training slice's CUDA kernels: the SPN, the SuPAIR likelihood and the
posterior scan.  Imports nothing of JAX (the card's machine has none):
run there with `python -m pytest tests/test_torch_training_kernels.py -m
cuda --noconftest -q`.

Here, without a card: each wrapper refuses CPU tensors (it launches its
kernel or raises; the dispatch sends CPU tensors to the plain version
instead), and `ops/_build.py` names a library by its source, headers, flags
and defines.  On the card (`cuda` marker): each kernel against its plain
version evaluated in float64 on the trained model's inputs; the
tolerances are chip_smoke.py's (phases 6-8).
"""

import pytest
import torch

from stove_tpu_torch import tree
from stove_tpu_torch.envs import data as data_lib
from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops import fused_likelihood as flik
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan as fscan
from stove_tpu_torch.ops import fused_spn as fspn
from stove_tpu_torch.ops import glimpse

RUN = "ckpts/r4rp_bill_s32"


@pytest.fixture(scope="module")
def cpu_model():
    return StoveModel.from_run(RUN, device="cpu")


def test_wrappers_reject_cpu_tensors(cpu_model):
    cfg, specs = cpu_model.cfg, cpu_model.specs.supair
    prep = fspn.prepare(specs.obj, cpu_model.params["supair"]["obj_spn"])
    x = torch.rand(4, 100)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fspn.launch_kernel(specs.obj, prep, x, x)
    prep_b = fspn.prepare(specs.bg, cpu_model.params["supair"]["bg_spn"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        flik.launch_kernel(cfg, specs, prep, prep_b, torch.rand(2, 32, 32),
                           torch.rand(2, 3, 4))
    z1 = torch.zeros(2, 3, cfg.full_state_dim)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fscan.launch_kernel(fr.pack_params(cpu_model.params["dynamics"], cfg),
                            cfg, z1, z1[..., :2], z1[..., :2],
                            torch.zeros(2, 1, 3, 4), torch.ones(2, 1, 3, 4),
                            torch.zeros(2, 1, 3, cfg.full_state_dim))


def test_prepared_spn_layout(cpu_model):
    """The kernel's buffers: leaves in permuted order, softmax'd mixture
    weights of every level, log-softmax root."""
    spec = cpu_model.specs.supair.bg
    p = cpu_model.params["supair"]["bg_spn"]
    prep = fspn.prepare(spec, p)
    r, k = 1, 77
    v = int(spec.perms[r, k])
    torch.testing.assert_close(prep["mu"][r, k], p["leaf_mu"][r, v])
    torch.testing.assert_close(prep["logsd"][r, k],
                               torch.log(spn_lib._leaf_std(
                                   spec, p["leaf_raw_std"][r, v])))
    assert prep["bounds"].tolist() == [0, 128, 256, 384, 512, 640, 768, 896,
                                       1024]
    sizes = [p[f"sum_logits_{d}"].numel() for d in (2, 1, 0)]
    assert prep["sumw"].numel() == sum(sizes)
    torch.testing.assert_close(prep["sumw"][:sizes[0]].reshape(
        p["sum_logits_2"].shape).sum(-1), torch.ones(2, 4, 6))


def test_build_names_libraries_by_content(cpu_model):
    cfg, specs = cpu_model.cfg, cpu_model.specs.supair
    jobs = [fscan.job(cfg), fscan.job(cfg.with_overrides(
        velocity_obs="filtered")), fspn.job(specs.obj), fspn.job(specs.bg),
            flik.job(cfg, specs), fr.job(cfg)]
    names = {_build.library_path(*j).name for j in jobs}
    assert len(names) == len(jobs)
    assert "-DSTOVE_TB=8" in fscan.job(cfg)[1]
    assert "-DSTOVE_VEL_MODE=2" in fscan.job(cfg)[1]
    assert "-DBG_V=1024" in flik.job(cfg, specs)[1]


# ---------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = StoveModel.from_run(RUN, device=dev)
    gen = torch.Generator().manual_seed(0)
    B, T = 32, model.cfg.window
    ep = data_lib.generate(model.cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)
    with torch.no_grad():
        inf = model.infer(frames, None, generator=gen)
    boxes = torch.cat([inf.z[..., 0:2], inf.z[..., 2:4]], -1).reshape(
        B * T, 3, 4).contiguous()
    return model, frames, boxes, gen


def _f64(tree_):
    return tree.map_leaves(lambda x: x.double(), tree_)


@pytest.mark.cuda
def test_spn_kernel_matches_float64_plain(card):
    model, frames, boxes, _ = card
    specs, p = model.specs.supair, model.params["supair"]
    flat = frames.reshape(-1, 32, 32)
    with torch.no_grad():
        patches = glimpse.extract_glimpses(flat, boxes, 10).reshape(-1, 100)
        pw, bgv = flik.patch_weights(model.cfg, boxes)
        for spec, prm, x, w in ((specs.obj, p["obj_spn"], patches,
                                 pw.reshape(-1, 100)),
                                (specs.bg, p["bg_spn"], flat.reshape(-1, 1024),
                                 bgv.reshape(-1, 1024))):
            got = fspn.spn_log_prob_fused(spec, prm, x.contiguous(),
                                          w.contiguous())
            ref = spn_lib.spn_log_prob(spec, _f64(prm), x.double(),
                                       w.double())
            err = (got.double() - ref).abs() / ref.abs().clamp_min(100.0)
            assert err.max().item() <= 1e-5


@pytest.mark.cuda
def test_likelihood_kernel_matches_float64_plain(card):
    model, frames, boxes, _ = card
    cfg, specs, p = model.cfg, model.specs.supair, model.params["supair"]
    flat = frames.reshape(-1, 32, 32).contiguous()
    with torch.no_grad():
        got = flik.likelihood_fused(cfg, specs, p, flat, boxes)
        ref = flik.likelihood_reference(cfg, specs, _f64(p), flat.double(),
                                        boxes.double())
    err = (got.double() - ref).abs() / ref.abs().clamp_min(100.0)
    assert err.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(velocity_obs_full_std=False),
                                dict(velocity_obs="filtered")],
                         ids=["full_std", "t_frame_std", "filtered"])
def test_scan_kernel_matches_float64_plain(card, kw):
    """The scan dispatch (`scan_impl=pallas`) on the trained weights against
    the plain loop in float64, on the posterior's own inputs."""
    model, frames, _, gen = card
    cfg = model.cfg.with_overrides(scan_impl="pallas", **kw)
    B, T = frames.shape[:2]
    with torch.no_grad():
        mean, std = stove_lib.supair_lib.encode(
            model.params["supair"], cfg, frames.reshape(B * T, 32, 32))
        mean, std = mean.reshape(B, T, 3, 4), std.reshape(B, T, 3, 4)
        m1, s1 = stove_lib.align_slots(mean[:, 0, :, 2:4], mean[:, 1, :, 2:4],
                                       mean[:, 1], std[:, 1])
        z1 = torch.cat([m1, m1[..., 2:4] - mean[:, 0, :, 2:4],
                        torch.randn((B, 3, cfg.cl), generator=gen).to(
                            frames.device)], -1)
        args = [z1, m1[..., 2:4], s1[..., 2:4], mean[:, 2:], std[:, 2:],
                torch.zeros((B, T - 2), dtype=torch.long,
                            device=frames.device),
                torch.randn((B, T - 2, 3, cfg.full_state_dim),
                            generator=gen).to(frames.device)]
        before = fscan.launch_kernel.launches
        got = stove_lib.scan_posterior(model.params["dynamics"], cfg, *args)
        ref = fscan.scan_reference(
            _f64(model.params["dynamics"]), cfg,
            *[a if a.dtype == torch.long else a.double() for a in args])
    assert fscan.launch_kernel.launches == before + 1
    for name, a, b in zip(("z", "z_mean"), got[:2], ref[:2]):
        assert (a.double() - b).abs().max().item() <= 1e-4, name
    assert ((got[2].double() - ref[2]).abs()
            / ref[2].abs()).max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 13])
def test_kernels_on_ragged_batches(card, B):
    """Batches that do not fill the last block (4 warps; TB=8 samples),
    and the likelihood without the overlap correction."""
    model, frames, boxes, gen = card
    cfg, specs, p = model.cfg, model.specs.supair, model.params["supair"]
    flat = frames.reshape(-1, 32, 32)[:B].contiguous()
    bx = boxes[:B].contiguous()
    with torch.no_grad():
        for c in (cfg, cfg.with_overrides(overlap_correction=False)):
            got = flik.likelihood_fused(c, specs, p, flat, bx)
            ref = flik.likelihood_reference(c, specs, _f64(p), flat.double(),
                                            bx.double())
            err = (got.double() - ref).abs() / ref.abs().clamp_min(100.0)
            assert err.max().item() <= 1e-5
        x = flat.reshape(B, -1)
        w = torch.rand(x.shape, generator=gen).to(x.device)
        got = fspn.spn_log_prob_fused(specs.bg, p["bg_spn"], x, w)
        ref = spn_lib.spn_log_prob(specs.bg, _f64(p["bg_spn"]), x.double(),
                                   w.double())
        assert ((got.double() - ref).abs()
                / ref.abs().clamp_min(100.0)).max().item() <= 1e-5
        D = cfg.full_state_dim
        args = [0.1 * torch.randn((B, 3, D), generator=gen),
                0.1 * torch.randn((B, 3, 2), generator=gen),
                0.1 + 0.1 * torch.rand((B, 3, 2), generator=gen),
                0.3 * torch.randn((B, 6, 3, 4), generator=gen),
                0.05 + 0.1 * torch.rand((B, 6, 3, 4), generator=gen)]
        args = [a.to(frames.device) for a in args]
        acts = torch.zeros((B, 6), dtype=torch.long, device=frames.device)
        eps = torch.randn((B, 6, 3, D), generator=gen).to(frames.device)
        got = fscan.scan_fused(model.params["dynamics"], cfg, *args, acts, eps)
        ref = fscan.scan_reference(_f64(model.params["dynamics"]), cfg,
                                   *[a.double() for a in args], acts,
                                   eps.double())
    assert (got[0].double() - ref[0]).abs().max().item() <= 1e-4
    assert ((got[2].double() - ref[2]).abs()
            / ref[2].abs().clamp_min(1.0)).max().item() <= 2e-5


@pytest.mark.cuda
def test_scan_with_actions_and_reward_head(card):
    """The scan library with actions and the reward head
    (ckpts/r4a_dense_s2's weights) on random inputs and actions, B=13 (a
    ragged last block), 4 steps: z within 1e-4 and rewards within 1e-4 of
    the plain version in float64, kl within 2e-5 relative."""
    _, frames, _, gen = card
    run = "ckpts/r4a_dense_s2"
    model = StoveModel.from_run(run, device=frames.device)
    cfg, dyn = model.cfg, model.params["dynamics"]
    B, T2, D = 13, 4, cfg.full_state_dim
    args = [0.1 * torch.randn((B, 3, D), generator=gen),
            0.1 * torch.randn((B, 3, 2), generator=gen),
            0.1 + 0.1 * torch.rand((B, 3, 2), generator=gen),
            0.3 * torch.randn((B, T2, 3, 4), generator=gen),
            0.05 + 0.1 * torch.rand((B, T2, 3, 4), generator=gen)]
    args = [a.to(frames.device) for a in args]
    acts = torch.randint(0, cfg.num_actions, (B, T2), generator=gen).to(
        frames.device)
    eps = torch.randn((B, T2, 3, D), generator=gen).to(frames.device)
    before = fscan.launch_kernel.launches
    with torch.no_grad():
        got = fscan.scan_fused(dyn, cfg, *args, acts, eps)
        ref = fscan.scan_reference(_f64(dyn), cfg, *[a.double() for a in args],
                                   acts, eps.double())
    assert fscan.launch_kernel.launches == before + 1
    assert (got[0].double() - ref[0]).abs().max().item() <= 1e-4
    assert ((got[2].double() - ref[2]).abs()
            / ref[2].abs().clamp_min(1.0)).max().item() <= 2e-5
    assert (got[3].double() - ref[3]).abs().max().item() <= 1e-4
