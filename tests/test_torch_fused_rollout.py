"""The fused rollout's wrapper, packed weights and plain version on the CPU;
the CUDA kernel itself is checked on the card (tests marked `cuda`, and
chip_smoke.py).

`_kernel_math` repeats the kernel's data flow step by step from the packed
buffer — the (h, 2h) receiver|sender matrix, ordered pairs without the
diagonal, the attention column, [s ; r] against the stacked output layer,
the zero-padded last layer — so a wrong segment order or split in
`prepare_params` fails here, without a card.
"""

import numpy as np
import pytest
import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.train import checkpoint as ckpt

RUN = "ckpts/r4rp_bill_s32"


@pytest.fixture(scope="module")
def trained():
    return (ckpt.load_config(RUN),
            ckpt.load_params(RUN, device="cpu")["dynamics"])


def _z0(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.zeros(B, cfg.num_obj, cfg.full_state_dim)
    z[..., 0:2] = 0.24
    z[..., 2:4] = torch.rand(B, cfg.num_obj, 2, generator=g) * 1.4 - 0.7
    z[..., 4:6] = torch.randn(B, cfg.num_obj, 2, generator=g) * 0.05
    z[..., 6:] = torch.randn(B, cfg.num_obj, cfg.cl, generator=g) * 0.5
    return z


def _segments(flat, cfg):
    seg, off = {}, 0
    for name, shape in fr.param_layout(cfg):
        n = int(np.prod(shape))
        seg[name] = flat[off:off + n].reshape(shape)
        off += n
    assert off == flat.numel()
    return seg


def _kernel_math(flat, cfg, z, H):
    p = _segments(flat, cfg)
    O, cl, h = cfg.num_obj, cfg.cl, cfg.dyn_hidden
    outs = []
    for _ in range(H):
        e = torch.relu(z @ p["w_e0"] + p["b_e0"]) @ p["w_e1"] + p["b_e1"]
        s = torch.relu(e @ p["w_s0"] + p["b_s0"]) @ p["w_s1"] + p["b_s1"]
        rs = e @ p["w_rs"]
        r = torch.zeros_like(s)
        for o in range(O):
            for j in range(O):
                if j == o:
                    continue
                h1 = torch.relu(rs[:, o, :h] + rs[:, j, h:] + p["b_r0"])
                h2 = torch.relu(h1 @ p["w_r1"] + p["b_r1"])
                att = torch.sigmoid(h2 @ p["w_ra"] + p["b_ra"][0])
                r[:, o] += (h2 @ p["w_rf"] + p["b_rf"]) * att[:, None]
        g = torch.relu(torch.cat([s, r], -1) @ p["w_o0"] + p["b_o0"])
        out = torch.relu(g @ p["w_o1"] + p["b_o1"]) @ p["w_o2"] + p["b_o2"]
        assert not out[..., 6 + 2 * cl:].any()          # zero padding
        vel = z[..., 4:6] + out[..., 0:2]
        z = torch.cat([z[..., :2], z[..., 2:4] + vel, vel,
                       z[..., 6:] + out[..., 2:2 + cl]], -1)
        outs.append(z)
    return torch.stack(outs, 1)


def test_packed_weights_reproduce_the_rollout(trained):
    cfg, dyn = trained
    flat = fr.prepare_params(dyn, cfg)
    assert flat.dtype == torch.float32 and flat.dim() == 1
    assert flat.numel() == sum(int(np.prod(s)) for _, s in
                               fr.param_layout(cfg))
    z0 = _z0(cfg, 16, 0)
    ref, _ = fr.rollout_states_reference(dyn, cfg, z0, 4)
    # same math, other summation order: atol 1e-4 after 4 chaotic steps
    torch.testing.assert_close(_kernel_math(flat, cfg, z0, 4), ref,
                               rtol=0, atol=1e-4)


def test_cpu_wrapper_runs_the_plain_version(trained):
    cfg, dyn = trained
    z0 = _z0(cfg, 8, 1)
    before = fr.launch_kernel.launches
    mean = fr.rollout_states(dyn, cfg, z0, 3, sample=False)
    torch.testing.assert_close(
        mean, fr.rollout_states_reference(dyn, cfg, z0, 3)[0], rtol=0, atol=0)
    g = torch.Generator().manual_seed(4)
    noise = torch.randn((8, 3) + tuple(z0.shape[1:]), generator=g)
    sampled = fr.rollout_states(dyn, cfg, z0, 3, True,
                                torch.Generator().manual_seed(4))
    torch.testing.assert_close(
        sampled, fr.rollout_states_reference(dyn, cfg, z0, 3, noise)[0],
        rtol=0, atol=0)
    assert fr.launch_kernel.launches == before   # no kernel on the CPU


def test_kernel_wrapper_rejects_cpu_tensors(trained):
    cfg, dyn = trained
    flat = fr.prepare_params(dyn, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.launch_kernel(flat, cfg, _z0(cfg, 4, 2), 3, False, 0)


@pytest.mark.parametrize("kw", [
    dict(open_loop_sigma=True),
    dict(dyn_layers=3),
], ids=["open_sigma", "depth"])
def test_unsupported_configs_raise(kw):
    """An open-loop std head that is not the two-layer MLP the kernel
    computes, and other depths, raise (actions, the reward head and the
    open-loop head are supported: tests/test_torch_avoidance.py and
    tests/test_torch_gravity.py)."""
    cfg = Config().with_overrides(**kw)
    params = {"reward": [], "open": []}
    with pytest.raises(ValueError):
        fr.check_supported(cfg, params)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rollout kernel is CUDA C++")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 100, 256])
def test_kernel_matches_plain_version(trained, cuda_device, B):
    """The float32 kernel against the plain version evaluated in float64 (its
    own rounding error), over 4 steps: the latent rows are an order of
    magnitude larger than the positions and the trained map amplifies
    float32 rounding at every step, so 1e-4 is held over 4 steps, not 8."""
    cfg, dyn = trained
    z0 = _z0(cfg, B, 3).to(cuda_device)
    got = fr.rollout_states(ckpt.params_from_numpy(dyn, cuda_device), cfg,
                            z0, 4, sample=False)
    ref, _ = fr.rollout_states_reference(
        ckpt.params_from_numpy(dyn, cuda_device, torch.float64), cfg,
        z0.double(), 4)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_kernel_noise_moments(trained, cuda_device):
    cfg, dyn = trained
    dyn = ckpt.params_from_numpy(dyn, cuda_device)
    z0 = _z0(cfg, 16384, 4).to(cuda_device)
    s = fr.rollout_states(dyn, cfg, z0, 1, True,
                          torch.Generator().manual_seed(0))[:, 0]
    d = fr.dyn_lib.apply(dyn, cfg, z0)
    eps = (s - d.mean) / (cfg.rollout_sigma_temp * d.std_open)
    assert abs(eps.mean().item()) < 0.01
    assert abs(eps.std().item() - 1.0) < 0.01
    assert (eps.abs() > 5).float().mean().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(360, 1), (100, 8)])
def test_action_kernel_matches_plain_version(cuda_device, B, H):
    """The action-conditioned kernel with its reward head (ckpts/r4a_dense_s2)
    against the plain version evaluated in float64.  On these random states
    the trained map amplifies float32 rounding step by step, so, as
    chip_smoke.py phase (2) holds long rollouts, the kernel's distance from
    float64 (states and rewards) is held to at most twice the float32 plain
    version's own; one step is also held to 1e-5 absolute.  chip_smoke.py
    phase (12) holds posterior states to 1e-4 absolute over 8 steps."""
    run = "ckpts/r4a_dense_s2"
    cfg = ckpt.load_config(run)
    dyn = ckpt.load_params(run, device=cuda_device)["dynamics"]
    z0 = _z0(cfg, B, 6).to(cuda_device)
    acts = torch.randint(0, cfg.num_actions, (B, H), device=cuda_device)
    before = fr.launch_kernel.launches
    s, r = fr.rollout(dyn, cfg, z0, H, sample=False, actions=acts)
    assert fr.launch_kernel.launches == before + 1
    ps, pr = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts)
    d64 = ckpt.params_from_numpy(dyn, cuda_device, torch.float64)
    ws, wr = fr.rollout_states_reference(d64, cfg, z0.double(), H, None, acts)
    for got, plain, want in ((s, ps, ws), (r, pr, wr)):
        k = (got.double() - want).abs().max().item()
        p = (plain.double() - want).abs().max().item()
        assert k <= 2 * p + 1e-6, (k, p)
        if H == 1:
            assert k <= 1e-5, k


@pytest.mark.cuda
def test_open_head_kernel_injects_the_open_std(cuda_device):
    """The sampled library with the open-loop std head (ckpts/r4rp_grav_s32):
    the same seed through the library without the head draws the same
    normals, so the std the open library injected, implied from its sample
    and those normals, is rollout_sigma_temp * std_open of the plain head
    (1e-2 relative where the normal is above 0.5; chip_smoke.py phase (20)
    measured 1.1e-4 at most); the recovered normals have phase (3)'s
    moments."""
    run = "ckpts/r4rp_grav_s32"
    cfg = ckpt.load_config(run)
    dyn = ckpt.load_params(run, device=cuda_device)["dynamics"]
    prep = fr.prepare_params(dyn, cfg)
    z0 = _z0(cfg, 16384, 7).to(cuda_device)
    mean, _ = fr.launch_kernel(prep, cfg, z0, 1, False, 0)
    plain_noise, _ = fr.launch_kernel(prep, cfg, z0, 1, True, 11)
    before = fr.launch_kernel.launches
    s, _ = fr.launch_kernel(prep, cfg, z0, 1, True, 11, None, True)
    assert fr.launch_kernel.launches == before + 1
    d = fr.dyn_lib.apply(dyn, cfg, z0)
    temp = cfg.rollout_sigma_temp
    eps = (plain_noise - mean)[:, 0] / (temp * d.std)
    mask = eps.abs() > 0.5
    mask[..., :2] = False
    implied = ((s - mean)[:, 0] / eps)[mask]
    want = (temp * d.std_open)[mask]
    assert ((implied - want).abs() / want).max().item() <= 1e-2
    e = (s[:, 0] - d.mean) / (temp * d.std_open)
    assert abs(e.mean().item()) < 0.01 and abs(e.std().item() - 1) < 0.01
    assert (e.abs() > 5).float().mean().item() < 1e-5
