"""Billiards physics and rendering of the port against the JAX package.

From the same numpy initial states both step 30 frames at the billiards
configuration's speed; the states agree to 1e-4 arena units (1/80 of a
pixel): the two frameworks round the impulse arithmetic differently by an
ulp now and then, and billiards amplifies such differences at every
collision (observed ~2e-6 after 30 steps here; at 2.6x the speed the same
ulp grows past 1e-3).  The uint8-quantised frames differ by at most one
level.  Every sequence has a ball-ball collision and some hit a wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.envs import physics as jphys
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.envs import physics as tphys

T = 30


def _init(cfg, n, seed):
    """Random starts, forced into contact: ball 1 sits next to ball 0,
    moving towards it, so every sequence has a ball-ball collision."""
    rng = np.random.default_rng(seed)
    r = cfg.ball_radius
    pos = rng.uniform(r + 2.5, cfg.arena_size - r - 2.5,
                      (n, cfg.num_obj, 2)).astype(np.float32)
    pos[:, 1] = pos[:, 0] + np.float32(2 * r + 0.4)
    for o in range(2, cfg.num_obj):
        pos[:, o] = rng.uniform(r, cfg.arena_size - r, (n, 2))
    ang = rng.uniform(0, 2 * np.pi, (n, cfg.num_obj))
    vel = (cfg.init_speed * np.stack([np.cos(ang), np.sin(ang)], -1)
           ).astype(np.float32)
    vel[:, 1] = [-cfg.init_speed, 0.1]
    vel[:, 0] = [cfg.init_speed, -0.1]
    return pos, vel


@pytest.mark.parametrize("seed", [5, 7])
def test_billiards_steps_match_jax(seed):
    jc = JConfig().with_overrides(seq_len=T)
    tc = TConfig.from_json(jc.to_json())
    pos, vel = _init(jc, 6, seed)
    radii = np.full((6, jc.num_obj), jc.ball_radius, np.float32)
    masses = np.ones((6, jc.num_obj), np.float32)

    step = jax.jit(jax.vmap(lambda s: jphys.billiards_step_full(jc, s)))
    js = jphys.EnvState(jnp.asarray(pos), jnp.asarray(vel),
                        jnp.asarray(radii), jnp.asarray(masses))
    ts = tphys.EnvState(*(torch.from_numpy(a) for a in
                          (pos, vel, radii, masses)))
    any_touch = np.zeros(6, bool)
    wall = np.zeros(6, bool)
    for _ in range(T):
        js, jt = step(js)
        ts, tt = tphys.billiards_step_full(tc, ts)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.pos, js.pos, rtol=0, atol=1e-4)
        np.testing.assert_allclose(ts.vel, js.vel, rtol=0, atol=1e-4)
        any_touch |= np.asarray(jt).any(1)
        p = np.asarray(js.pos)
        wall |= ((p < jc.ball_radius + 0.6)
                 | (p > jc.arena_size - jc.ball_radius - 0.6)).any((1, 2))
    assert any_touch.all()          # every sequence had a ball collision
    assert wall.any()               # and some reached a wall

    jf = jax.vmap(lambda p, r: jphys.render(jc, p, r))(js.pos, js.radii)
    tf = tphys.render(tc, ts.pos, ts.radii)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-4)
    q = lambda f: np.round(np.asarray(f) * 255.0).astype(np.int32)
    assert np.abs(q(tf) - q(jf)).max() <= 1


def test_render_sequence_matches_jax():
    jc = JConfig().with_overrides(seq_len=T)
    tc = TConfig.from_json(jc.to_json())
    rng = np.random.default_rng(3)
    positions = rng.uniform(0, jc.arena_size, (2, 5, jc.num_obj, 2)).astype(
        np.float32)
    radii = np.full((2, jc.num_obj), jc.ball_radius, np.float32)
    want = np.stack([jphys.render_sequence(jc, positions[i], radii[i])
                     for i in range(2)])
    got = tphys.render_sequence(tc, torch.from_numpy(positions),
                                torch.from_numpy(radii))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_generate_corpus_properties():
    tc = TConfig().with_overrides(seq_len=T)
    ep = tdata.generate(tc, 5, torch.Generator().manual_seed(0))
    assert ep.frames.shape == (5, T, 32, 32) and ep.frames.dtype == torch.uint8
    assert ep.states.shape == (5, T, tc.num_obj, 4)
    p = ep.states[..., :2]
    assert (p >= tc.ball_radius - 1e-4).all()
    assert (p <= tc.arena_size - tc.ball_radius + 1e-4).all()
    # elastic billiards: per-sequence kinetic energy is conserved
    ke = (ep.states[..., 2:4] ** 2).sum((-2, -1))
    torch.testing.assert_close(ke, ke[:, :1].expand_as(ke), rtol=1e-4,
                               atol=1e-5)
    # the first frame renders the first recorded positions
    frame0 = tphys.render(tc, ep.states[:, 0, :, :2], ep.radii)
    assert (torch.round(frame0 * 255).to(torch.uint8) == ep.frames[:, 0]).all()
    # initial states do not overlap
    d = torch.cdist(ep.states[:, 0, :, :2], ep.states[:, 0, :, :2])
    off = ~torch.eye(tc.num_obj, dtype=torch.bool)
    assert (d[:, off] >= 2 * tc.ball_radius - 1e-3).all()
    again = tdata.generate(tc, 5, torch.Generator().manual_seed(0))
    assert torch.equal(again.frames, ep.frames)


def test_model_coordinate_maps():
    tc = TConfig()
    x = torch.tensor([0.0, 5.0, 10.0])
    torch.testing.assert_close(tdata.arena_to_model(tc, x),
                               torch.tensor([-1.0, 0.0, 1.0]))
    torch.testing.assert_close(tdata.model_to_arena(
        tc, tdata.arena_to_model(tc, x)), x)
    np.testing.assert_allclose(
        tdata.normalize_frames(torch.tensor([0, 255], dtype=torch.uint8)),
        np.asarray(jdata.normalize_frames(jnp.asarray([0, 255], jnp.uint8))))
