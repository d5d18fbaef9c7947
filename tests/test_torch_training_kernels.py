"""The training slice's CUDA kernels: the SPN, the SuPAIR likelihood and the
posterior scan.  Imports nothing of JAX (the card's machine has none):
run there with `python -m pytest tests/test_torch_training_kernels.py -m
cuda --noconftest -q`.

Here, without a card: each wrapper refuses CPU tensors (it launches its
kernel or raises; the dispatch sends CPU tensors to the plain version
instead), and `ops/_build.py` names a library by its source, headers, flags
and defines.  On the card (`cuda` marker): each kernel against its plain
version evaluated in float64 on the trained model's inputs; the
tolerances are chip_smoke.py's (phases 6-8).  The scan's float32 library is
held there (its dispatch's forward set to float32); its bfloat16 library,
the dispatch's forward, against the plain loop at bf16 by
bf16_parity.hold_bf16.  Both scan libraries run on the rollout's
tensor-core dynamics core, at the tile `fused_scan.tile_for` picks.
"""

import numpy as np
import pytest
import torch

from bf16_parity import hold_bf16
from stove_tpu_torch import tree
from stove_tpu_torch.envs import data as data_lib
from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.models import supair
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops import fused_likelihood as flik
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan as fscan
from stove_tpu_torch.ops import fused_spn as fspn
from stove_tpu_torch.ops import glimpse
from stove_tpu_torch.tools import scan_probe

RUN = "ckpts/r4rp_bill_s32"
# every draw of test_kernels_on_ragged_batches: the scan kernel's distance
# from float64, z and kl relative.  tools/scan_probe.py reading 4 over 24
# draws at each of B = 255, 1055, 2113, 4096 (NVIDIA H100 80GB HBM3,
# 700 W): the kernel's largest 1.57e-3 and 4.1e-5, the plain float32
# loop's own 2.60e-3 and 5.8e-5; the ceilings are 1.5x the plain loop's.
RAGGED_Z_CEIL = 4e-3
RAGGED_KL_CEIL = 1e-4


@pytest.fixture(scope="module")
def cpu_model():
    return StoveModel.from_run(RUN, device="cpu")


def test_wrappers_reject_cpu_tensors(cpu_model):
    cfg, specs = cpu_model.cfg, cpu_model.specs.supair
    prep = fspn.prepare(specs.obj, cpu_model.params["supair"]["obj_spn"])
    x = torch.rand(4, 100)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fspn.launch_kernel(specs.obj, prep, x, x)
    packed = flik.prepare(cfg, specs, cpu_model.params["supair"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        flik.launch_kernel(cfg, specs, packed, torch.rand(2, 32, 32),
                           torch.rand(2, 3, 4))
    z1 = torch.zeros(2, 3, cfg.full_state_dim)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fscan.launch_kernel(fscan.prepare_params(cpu_model.params["dynamics"],
                                                 cfg),
                            cfg, z1, z1[..., :2], z1[..., :2],
                            torch.zeros(2, 1, 3, 4), torch.ones(2, 1, 3, 4),
                            torch.zeros(2, 1, 3, cfg.full_state_dim))


def test_prepared_spn_layout(cpu_model):
    """The packed buffer (`fused_spn.pack_reference`, the packing kernel's
    plain version) against the JAX package's `pallas_spn._prepare` on the
    same numpy-seeded parameters, for both SPN shapes: the leaves in
    permuted order as (mu, sqrt(1/2)/sd, -log sd - log(2 pi)/2, the
    variable's bits), every level's softmaxed weights [p][s][i*c + j] (the
    JAX kernel's W2T[p, j, s*c + i]), the root log-weights; and the leaf
    regions the evaluator sums (spn_tile.cuh's `bound`) are the JAX scope
    matrix's.  The JAX package is imported here, not at the top: the card's
    machine runs this file's `cuda` tests without it."""
    import jax.numpy as jnp
    from stove_tpu.models import spn as jspn
    from stove_tpu.ops import pallas_spn
    rng = np.random.default_rng(11)
    for spec, tp in ((cpu_model.specs.supair.obj,
                      cpu_model.params["supair"]["obj_spn"]),
                     (cpu_model.specs.supair.bg,
                      cpu_model.params["supair"]["bg_spn"])):
        R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                         spec.num_sums, spec.depth)
        L = 2 ** D
        raw = {k: (rng.uniform(size=v.shape) if k == "leaf_mu"
                   else rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in tp.items()}
        buf = fspn.pack_reference(spec, {k: torch.from_numpy(v)
                                         for k, v in raw.items()}).numpy()
        mu_t, std_t, scope_t, w2t, root = pallas_spn._prepare(
            jspn.SpnSpec(*spec), {k: jnp.asarray(v) for k, v in raw.items()})
        lay = fspn.layout(spec)
        assert buf.size == lay["floats"]
        leaf = buf[:lay["leaf"]].reshape(R, V, I, 4)
        perm = spec.perms
        by_k = np.take_along_axis(np.asarray(std_t).transpose(0, 2, 1),
                                  perm[:, :, None], 1)          # (R, V, I)
        np.testing.assert_array_equal(
            leaf[..., 0], np.take_along_axis(
                np.asarray(mu_t).transpose(0, 2, 1), perm[:, :, None], 1))
        np.testing.assert_allclose(leaf[..., 1], np.sqrt(0.5) / by_k,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            leaf[..., 2], -np.log(by_k) - 0.5 * np.log(2 * np.pi),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(leaf[..., 3].view(np.int32),
                                      np.repeat(perm[:, :, None], I, 2))
        c = I
        for lvl, d in enumerate(range(D - 1, -1, -1)):
            off, wrep = lay["levels"][d]
            P = 2 ** d
            got = buf[off:off + R * wrep].reshape(R, wrep)[:, :P * S * c * c]
            want = np.asarray(w2t[lvl]).reshape(R, P, c, S, c).transpose(
                0, 1, 3, 4, 2)                            # [r, p, s, i, j]
            np.testing.assert_allclose(got.reshape(R, P, S, c, c), want,
                                       rtol=1e-6, atol=1e-7)
            c = S
        np.testing.assert_allclose(buf[lay["root"]:lay["root"] + R * S],
                                   np.asarray(root), rtol=1e-6, atol=1e-6)

        def bound(l):                     # spn_tile.cuh's SpnLayout::bound
            q, rem = divmod(l * V, L)
            return q + 1 if 2 * rem > L else q + (q & 1) if 2 * rem == L else q

        scope = np.asarray(scope_t)                       # (R, V, L)
        for r in range(R):
            for l in range(L):
                region = np.zeros(V, np.float32)
                region[perm[r, bound(l):bound(l + 1)]] = 1.0
                np.testing.assert_array_equal(scope[r, :, l], region)


def test_likelihood_grids_are_cached_linspaces():
    """The likelihood wrapper's sample grids, built once per (device, P,
    H), equal the plain version's torch.linspace exactly."""
    cpu = torch.device("cpu")
    gp, gi = flik.grids(cpu, 10, 32)
    assert flik.grids(cpu, 10, 32)[0] is gp
    assert torch.equal(gp, torch.linspace(-1.0, 1.0, 10))
    assert torch.equal(gi, torch.linspace(-1.0, 1.0, 32))
    assert torch.equal(flik.grids(cpu, 7, 5)[1], torch.linspace(-1.0, 1.0, 5))


def test_tile_rule_fills_the_card(cpu_model):
    """One tile, 8 samples a block, in every SPN and likelihood library:
    the training step's 2048 frames and 6144 patches launch at least a
    block per SM of the H100's 132."""
    cfg, specs = cpu_model.cfg, cpu_model.specs.supair
    assert fspn.TILE == 8
    n = cfg.batch_size * cfg.window
    assert min(-(-n // fspn.TILE), -(-n * cfg.num_obj // fspn.TILE)) >= 132
    for spec in (specs.obj, specs.bg):
        assert f"-DSPN_TB={fspn.TILE}" in fspn.job(spec)[1]
    assert f"-DLIK_TB={fspn.TILE}" in flik.job(cfg, specs)[1]


def test_build_names_libraries_by_content(cpu_model):
    cfg, specs = cpu_model.cfg, cpu_model.specs.supair
    jobs = [fscan.job(cfg), fscan.job(cfg.with_overrides(
        velocity_obs="filtered")), fspn.job(specs.obj), fspn.job(specs.bg),
            flik.job(cfg, specs), fr.job(cfg)]
    names = {_build.library_path(*j).name for j in jobs}
    assert len(names) == len(jobs)
    assert f"-DSTOVE_TB={fscan.tile_for(cfg.batch_size)}" in fscan.job(cfg)[1]
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
@pytest.mark.parametrize("setting", [dict(spn_impl="matmul"),
                                     dict(overlap_impl="image"),
                                     dict(overlap_impl="image",
                                          spn_impl="matmul")],
                         ids=["matmul", "image", "image-matmul"])
def test_supair_settings_match_float64_plain(card, setting):
    """The plain likelihood's settings without a kernel on the card:
    `spn_impl="matmul"` (three float32 products a SPN, TF32 off) and the
    image-space claim weights, on the trained model's frames and
    posterior boxes, against the dense plain version in float64 with the
    same claim weights: 1e-5 of max(|log p|, 100), the SPN kernels'
    limit.  Nothing launches a kernel."""
    model, frames, boxes, _ = card
    cfg = model.cfg.with_overrides(**setting)
    specs, p = model.specs.supair, model.params["supair"]
    flat = frames.reshape(-1, 32, 32)
    before = (fspn.launch_kernel.launches, flik.launch_kernel.launches)
    with torch.no_grad():
        got = supair.likelihood(p, cfg, specs, flat, boxes)
        ref = supair.likelihood(_f64(p), cfg.with_overrides(spn_impl="dense"),
                                specs, flat.double(), boxes.double())
    assert (fspn.launch_kernel.launches, flik.launch_kernel.launches) == before
    err = (got.double() - ref).abs() / ref.abs().clamp_min(100.0)
    assert err.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(velocity_obs_full_std=False),
                                dict(velocity_obs="filtered")],
                         ids=["full_std", "t_frame_std", "filtered"])
def test_scan_kernel_matches_float64_plain(card, kw):
    """The scan's float32 library (`fused_scan.scan_kernel`) on the trained
    weights against the plain loop in float64, on the posterior's own
    inputs (the dispatch `scan_impl=pallas` launches the bf16 library:
    test_bf16_scan_matches_plain_bf16)."""
    model, frames, _, gen = card
    cfg = model.cfg.with_overrides(**kw)
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
        got = fscan.scan_kernel(model.params["dynamics"], cfg, *args,
                                dtype="float32")
        ref = fscan.scan_reference(
            _f64(model.params["dynamics"]), cfg,
            *[a if a.dtype == torch.long else a.double() for a in args])
    assert fscan.launch_kernel.launches == before + 1
    for name, a, b in zip(("z", "z_mean"), got[:2], ref[:2]):
        assert (a.double() - b).abs().max().item() <= 1e-4, name
    assert ((got[2].double() - ref[2]).abs()
            / ref[2].abs()).max().item() <= 2e-5


@pytest.mark.cuda
def test_packing_kernels_match_plain_version(card):
    """The packing kernels (`fused_spn.prepare`, both SPNs of
    `fused_likelihood.prepare` in one launch) against `pack_reference`:
    1e-6 relative to max(|value|, 1) (expf/logf against torch's), the
    variables' bits equal."""
    model = card[0]
    specs, p = model.specs.supair, model.params["supair"]
    both = flik.prepare(model.cfg, specs, p)
    for spec, prm, lik_buf in ((specs.obj, p["obj_spn"], both[0]),
                               (specs.bg, p["bg_spn"], both[1])):
        ref = fspn.pack_reference(spec, prm)
        leaf = fspn.layout(spec)["leaf"]
        for got in (fspn.prepare(spec, prm), lik_buf):
            assert torch.equal(got[3:leaf:4].view(torch.int32),
                               ref[3:leaf:4].view(torch.int32))
            keep = torch.ones_like(ref, dtype=torch.bool)
            keep[3:leaf:4] = False
            err = ((got - ref).abs() / ref.abs().clamp_min(1.0))[keep]
            assert err.max().item() <= 1e-6


def _hold_spn_and_likelihood(card, B, gen):
    """The likelihood (overlap correction on and off) and both SPNs on B
    frames, B patches, against the plain version in float64: 1e-5 of
    max(|log p|, 100); the background SPN's weights drawn from `gen`."""
    model, frames, boxes, _ = card
    cfg, specs, p = model.cfg, model.specs.supair, model.params["supair"]
    reps = -(-B // boxes.shape[0])
    flat = frames.reshape(-1, 32, 32).repeat(reps, 1, 1)[:B].contiguous()
    bx = boxes.repeat(reps, 1, 1)[:B].contiguous()
    with torch.no_grad():
        for c in (cfg, cfg.with_overrides(overlap_correction=False)):
            got = flik.likelihood_fused(c, specs, p, flat, bx)
            ref = flik.likelihood_reference(c, specs, _f64(p), flat.double(),
                                            bx.double())
            err = (got.double() - ref).abs() / ref.abs().clamp_min(100.0)
            assert err.max().item() <= 1e-5
        patches = glimpse.extract_glimpses(flat, bx, 10).reshape(-1, 100)
        for spec, prm, x, g in ((specs.bg, p["bg_spn"], flat.reshape(B, -1),
                                 gen),
                                (specs.obj, p["obj_spn"], patches[:B],
                                 torch.Generator().manual_seed(B))):
            x = x.contiguous()
            w = torch.rand(x.shape, generator=g).to(x.device)
            got = fspn.spn_log_prob_fused(spec, prm, x, w)
            ref = spn_lib.spn_log_prob(spec, _f64(prm), x.double(),
                                       w.double())
            assert ((got.double() - ref).abs()
                    / ref.abs().clamp_min(100.0)).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B", [7, 8, 9, 2047, 2049])
def test_spn_and_likelihood_on_tile_edges(card, B):
    """Tile - 1, tile and tile + 1 samples (`fused_spn.TILE`, 8 a block),
    and the training step's 2048 frames less and plus one: the last block
    short by one or holding one sample.  Held as in
    test_kernels_on_ragged_batches, on its own draws (the fixture's
    generator feeds that test's random states)."""
    _hold_spn_and_likelihood(card, B, torch.Generator().manual_seed(B))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 255, 257, 2113])
def test_kernels_on_ragged_batches(card, B):
    """Batches that do not fill the last block -- the SPN's and likelihood's
    8-sample tile, the scan's small tile (B < 2112) and its 16-sample tile
    (2113) -- and the likelihood without the overlap correction (the
    scan's float32 library), over eight draws: seeds 0-7, each draw from
    its own `torch.Generator().manual_seed(s)` (the SPN weights from one,
    the scan's random states and eps, `scan_probe.ragged_inputs`, from
    another), so that no draw depends on test order.  The fixture's 256
    frames repeat past B=256.  On these random states the trained map
    amplifies float32 rounding over the 6 steps, and the plain float32
    loop's own distance from float64 spreads several-fold between draws
    (tools/scan_probe.py reading 4), so the scan is held as the rollout
    test is: its distance from float64 averaged over the draws (z; kl
    relative to max(|kl|, 1)) at most twice the plain loop's average, or
    1e-4 (kl: 2e-5) where that is larger; and on every draw below
    RAGGED_Z_CEIL and RAGGED_KL_CEIL.  Phases (8) and (17) of
    chip_smoke.py hold the posterior's own inputs at B=255 and 2113 to
    1e-4."""
    model, frames, _, _ = card
    cfg = model.cfg
    dist = {"kernel": [], "plain": []}
    for s in range(scan_probe.TEST_SEEDS):
        _hold_spn_and_likelihood(card, B, torch.Generator().manual_seed(s))
        args, acts, eps = scan_probe.ragged_inputs(cfg, B, s, frames.device)
        with torch.no_grad():
            got = fscan.scan_kernel(model.params["dynamics"], cfg, *args,
                                    acts, eps, dtype="float32")
            ref = fscan.scan_reference(_f64(model.params["dynamics"]), cfg,
                                       *[a.double() for a in args], acts,
                                       eps.double())
            plain = fscan.scan_reference(model.params["dynamics"], cfg,
                                         *args, acts, eps)
        k = scan_probe.distances(got, ref)
        dist["kernel"].append(k)
        dist["plain"].append(scan_probe.distances(plain, ref))
        assert k[0] <= RAGGED_Z_CEIL and k[1] <= RAGGED_KL_CEIL, (s, k)
    mean = {key: np.mean(v, axis=0) for key, v in dist.items()}
    assert mean["kernel"][0] <= max(1e-4, 2 * mean["plain"][0]), dist
    assert mean["kernel"][1] <= max(2e-5, 2 * mean["plain"][1]), dist


@pytest.mark.cuda
def test_scan_with_actions_and_reward_head(card):
    """The scan's float32 library with actions and the reward head
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
        got = fscan.scan_kernel(dyn, cfg, *args, acts, eps, dtype="float32")
        ref = fscan.scan_reference(_f64(dyn), cfg, *[a.double() for a in args],
                                   acts, eps.double())
    assert fscan.launch_kernel.launches == before + 1
    assert (got[0].double() - ref[0]).abs().max().item() <= 1e-4
    assert ((got[2].double() - ref[2]).abs()
            / ref[2].abs().clamp_min(1.0)).max().item() <= 2e-5
    assert (got[3].double() - ref[3]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_bf16_scan_matches_plain_bf16(card):
    """The scan dispatch's forward, the bfloat16 library, on the trained
    weights and the posterior's own inputs (T2=6) against the plain loop at
    bf16, by hold_bf16 against the plain loop's bf16 - f32 distance; its
    gradient is the float32 plain loop's (tests/test_torch_rollout_bf16.py
    holds that on the CPU)."""
    model, frames, _, gen = card
    cfg = model.cfg.with_overrides(scan_impl="pallas")
    B, T = frames.shape[:2]
    dyn = model.params["dynamics"]
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
        got = stove_lib.scan_posterior(dyn, cfg, *args)
        assert fscan.launch_kernel.launches == before + 1
        bf = fscan.scan_reference(dyn, cfg, *args, dtype="bfloat16")
        f32 = fscan.scan_reference(dyn, cfg, *args)
    for i, name in ((0, "z"), (1, "z_mean")):
        hold_bf16(f"scan {name}", got[i], bf[i], f32[i], steps=T - 2)
