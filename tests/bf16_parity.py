"""The criterion that holds a bfloat16 result to its bfloat16 reference
(tests/test_torch_rollout_bf16.py explains it).  Imports nothing of JAX:
the card tests use it too."""

import numpy as np

# Limits on the entries that a rounding flip moves (the medians are held to
# `limit`): the largest |got - ref_bf16| of a step at most `max_ratio`
# times the largest |ref_bf16 - ref_f32|, and at most `share` of a step's
# entries (or one (sample, object) row's, where that is more) above 0.1x
# that largest distance.  A flip near a collision can move its row as far
# as every rounding together moves the worst one, and more of the rewards
# move than of the states.  PERF.md gives the readings, on the card over 24
# input draws and here, that set them.
STATES = dict(max_ratio=2.0, share=1e-2)
REWARDS = dict(max_ratio=2.0, share=3e-2)


def hold_bf16(name, got, ref_bf16, ref_f32, steps=4, axis=1, limit=0.1,
              max_ratio=STATES["max_ratio"], share=STATES["share"]):
    """At steps 1..`steps` along `axis` (the remaining axes: samples, then
    objects and columns), the median of |got - ref_bf16| over the step and
    over the (sample, object) entries of each last-axis column is at most
    `limit` times that of |ref_bf16 - ref_f32|; the maxima and the share of
    moved entries within `max_ratio` and `share` (STATES, REWARDS).  Prints
    each; returns the largest ratio of the maxima."""
    got, rb, rf = (np.moveaxis(np.asarray(
        x.detach().double().cpu() if hasattr(x, "detach") else x,
        np.float64), axis, 0) for x in (got, ref_bf16, ref_f32))
    worst = 0.0
    for t in range(steps):
        d, ref = np.abs(got[t] - rb[t]), np.abs(rb[t] - rf[t])
        cols = d.shape[-1] if d.ndim > 1 else 1
        ratio = d.max() / ref.max()
        moved = float(np.mean(d > 0.1 * ref.max()))
        rows = d.size // cols
        print(f"\n[{name}] step {t + 1}: |got - bf16 ref| max {d.max():.3e} "
              f"median {np.median(d):.3e}; |bf16 ref - f32 ref| max "
              f"{ref.max():.3e} median {np.median(ref):.3e}; ratio of the "
              f"maxima {ratio:.3f}, share above 0.1x {moved:.2e}", end="")
        assert np.median(ref) > 0, (name, t)
        assert np.median(d) <= limit * np.median(ref), (name, t)
        cd = np.median(d.reshape(-1, cols), axis=0)
        cr = np.median(ref.reshape(-1, cols), axis=0)
        assert (cd <= limit * cr).all(), (name, t, cd, cr)
        assert ratio <= max_ratio, (name, t, ratio)
        assert moved <= max(share, 1.0 / rows), (name, t, moved)
        worst = max(worst, ratio)
    print()
    return worst
