"""The fused epoch of the port's Trainer (`fused_epoch`, the reference's
whole-epoch lax.scan): one step captured as a CUDA graph on the card and
replayed, the same step run eagerly on the CPU at debug sizes (the
reference's rule, stove_tpu/train/trainer.py:253-261).  Imports nothing
of JAX (the card's machine has none): run the card test there with
`python -m pytest tests/test_torch_fused_epoch.py -m cuda --noconftest -q`.

Here, on the CPU: the fused epoch equals the step loop (fused_epoch=false)
bit for bit -- parameters, optimizer state and every step's metrics --
over a SuPAIR warm-up epoch and an ELBO epoch, for billiards and for the
action-conditioned avoidance model; the step body reads nothing back to
the host (every host-sync entry point patched to raise around one call);
two gloo ranks running fused epochs equal one process's step loop to
tests/test_torch_parallel.py's tolerances (metrics rtol 5e-3, parameters
1e-5: the ranks' sums reassociate float sums).  On the card (`cuda`
marker): one capture and three replays of the STOVE step equal three
eager steps, under cuDNN's deterministic algorithms, within twice the
distance between two eager runs (bit for bit where eager runs are).
"""

import numpy as np
import pytest
import torch

from stove_tpu_torch import main as tmain
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.parallel import dryrun
from stove_tpu_torch.train.trainer import (CapturedStep, STEP_KEYS,
                                            Trainer)

SHRUNK = ["num_train=8", "num_test=4", "seq_len=20", "batch_size=4",
          "eval_batch=2", "encoder_channels=(8,16)", "encoder_mlp_hidden=32",
          "obj_spn_num_sums=3", "obj_spn_num_leaves=3",
          "obj_spn_repetitions=2", "obj_spn_depth=1", "bg_spn_num_sums=2",
          "bg_spn_num_leaves=2", "bg_spn_depth=2", "bg_spn_repetitions=1",
          "dyn_hidden=32", "cl=4", "debug=true", "nolog=true",
          "eval_every=99", "ckpt_every=99", "num_epochs=2",
          "steps_per_epoch=2", "supair_only_epochs=1"]
# the presets anneal the rate linearly; billiards here runs at the base
# rate (no schedule state), avoidance on the cosine schedule
PRESETS = {"billiards": ("stove_billiards", ("debug_anneal_lr=0",)),
           "avoidance": ("stove_avoidance", ("anneal_shape=cosine",))}


def _cfg(name, tmp_path, *extra):
    preset, more = PRESETS[name]
    return tmain.build_config([f"preset={preset}", *SHRUNK, *more,
                               f"data_dir={tmp_path / 'data'}",
                               f"run_dir={tmp_path / 'runs'}", *extra])[0]


def _state(trainer):
    return [x.detach().clone().cpu() for x in
            tree.leaves(trainer.params) + tree.leaves(trainer.opt_state)
            if x is not None]


def _run(cfg, epochs=2):
    return dryrun.train_epochs(0, torch.device("cpu"), cfg.to_json(), epochs)


@pytest.mark.parametrize("name", list(PRESETS))
def test_fused_epoch_equals_the_step_loop(name, tmp_path):
    """fused_epoch=true (the eager body, by the debug rule) against
    fused_epoch=false: equal bit for bit.  The avoidance config trains
    through actions, the reward head and the balanced BCE, on the cosine
    schedule."""
    cfg = _cfg(name, tmp_path)
    fused = _run(cfg)
    loop = _run(cfg.with_overrides(fused_epoch=False))
    assert fused["fused"] and not fused["captured"] and not loop["fused"]
    assert fused["step"] == loop["step"] == 4
    assert [r.shape for r in fused["rows"]] == [(2, 3), (2, 9)]
    assert fused["keys"] == loop["keys"]
    assert set(fused["keys"][1]) >= {"loss", "elbo", "grad_norm"}
    for a, b in zip(fused["rows"] + fused["state"],
                    loop["rows"] + loop["state"]):
        assert torch.equal(a, b)


def test_debug_rule_on_the_cpu(tmp_path):
    """Without debug, the CPU runs the step loop even when fused_epoch is
    on (the reference's rule); fused_epoch=false never fuses."""
    cfg = _cfg("billiards", tmp_path)
    assert Trainer(cfg, device="cpu")._use_fused()
    assert not Trainer(cfg.with_overrides(debug=False),
                       device="cpu")._use_fused()
    assert not Trainer(cfg.with_overrides(fused_epoch=False),
                       device="cpu")._use_fused()


def _raiser(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"host sync in the step body: {name}")
    return fail


SYNCS = [(torch.Tensor, n) for n in ("item", "__int__", "__float__",
                                     "__bool__", "tolist", "numpy", "cpu")]
SYNCS += [(torch, "tensor"), (torch, "as_tensor")]


@pytest.mark.parametrize("name,kind", [("billiards", "supair"),
                                       ("billiards", "stove"),
                                       ("avoidance", "stove")])
def test_step_body_has_no_host_sync(name, kind, tmp_path):
    """After one warm-up call of the step (window sampling and the
    body), every host-sync entry point raises, and one more call trips
    none of them."""
    trainer = Trainer(_cfg(name, tmp_path), device="cpu")
    trainer._sampled_step(kind)
    saved = [(obj, n, getattr(obj, n)) for obj, n in SYNCS]
    try:
        for obj, n, _ in saved:
            setattr(obj, n, _raiser(n))
        row = trainer._sampled_step(kind)
    finally:
        for obj, n, fn in saved:
            setattr(obj, n, fn)
    assert row.shape == (len(STEP_KEYS[kind]),)
    assert torch.isfinite(row).all()


def test_two_gloo_ranks_fused_equal_one_process(tmp_path):
    """Two ranks over gloo run fused epochs (eagerly: gloo's all-reduce is
    not captured) and match one process's step loop, every step's
    metrics rtol 5e-3 (test_parallel.py:104), parameters and optimizer
    state 1e-5: the configuration and tolerances of
    tests/test_torch_parallel.py::test_two_epochs_at_two_ranks_match_one_rank
    (the preset's linear schedule)."""
    cfg = _cfg("billiards", tmp_path, "debug_anneal_lr=1.0")
    want = _run(cfg.with_overrides(fused_epoch=False))
    for out in dryrun.spawn(dryrun.train_epochs, 2, cfg.to_json(), 2):
        assert out["fused"] and not out["captured"]
        for got, ref in zip(out["rows"], want["rows"]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-3,
                                       atol=1e-5)
        for a, b in zip(out["state"], want["state"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)


def test_capture_counts_no_launch_and_replays_count_theirs():
    """The launch accounting of a captured step (`ops/launches.py`), on
    counts made by hand: what a capture counted (here one scan launch and
    one likelihood packing launch) is taken back out of the wrappers'
    counters, and each of three replays adds it, by library and in
    all."""
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import launches

    lib = "-DTEST_ONLY"
    scan0 = fscan.launch_kernel.launches
    try:
        snap = launches.by_library()
        fscan.launch_kernel.launches += 1
        fscan.launch_kernel.by_library[lib] = 1
        flik.prepare.by_library[lib] = 1
        per = launches.since(snap)
        assert per == {f"scan.cu {lib}": 1, f"likelihood.cu {lib} pack": 1}
        launches.add(per, -1)
        assert launches.since(snap) == {}
        assert fscan.launch_kernel.launches == scan0
        for _ in range(3):
            launches.add(per)
        assert launches.since(snap) == {k: 3 for k in per}
        assert fscan.launch_kernel.launches == scan0 + 3
    finally:
        fscan.launch_kernel.launches = scan0
        fscan.launch_kernel.by_library.pop(lib, None)
        flik.prepare.by_library.pop(lib, None)


# ------------------------------------------------------------ the card

@pytest.fixture
def card():
    """The card, with cuDNN's deterministic algorithms: its default
    convolution backward sums with atomics, so two eager runs would
    differ in their last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step is captured as a CUDA "
                    "graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _distance(a, b):
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(a, b))


@pytest.mark.cuda
def test_replays_equal_eager_steps(card, tmp_path):
    """A warm-up step, then three STOVE steps: eagerly in two Trainers,
    and as one capture and three replays in a third, from the same
    initial state and generator seeds.  The replays' metrics rows,
    parameters and optimizer state equal the eager steps' within twice
    the distance between the two eager runs."""
    cfg = Config().debug_shrunk().with_overrides(
        data_dir=str(tmp_path / "data"), nolog=True, supair_only_epochs=0)

    def eager():
        tr = Trainer(cfg, device=card)
        rows = [tr._sampled_step("stove") for _ in range(4)]
        return [r.clone() for r in rows] + _state(tr)

    a, b = eager(), eager()
    tr = Trainer(cfg, device=card)
    rows = [tr._sampled_step("stove").clone()]
    graph = CapturedStep(lambda: tr._sampled_step("stove"),
                         (tr.data_gen, tr.noise_gen))
    rows += [graph.replay().clone() for _ in range(3)]
    torch.cuda.synchronize()
    got = rows + _state(tr)
    floor = _distance(a, b)
    dist = _distance(got, a)
    print(f"replays vs eager {dist:.3e}, eager vs eager {floor:.3e}")
    assert all(torch.isfinite(r).all() for r in rows)
    assert dist <= 2 * floor
