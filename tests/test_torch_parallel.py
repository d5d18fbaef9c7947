"""Data parallelism of the port (`stove_tpu_torch/parallel/`) on the CPU:
ranks spawned by `parallel.dryrun.spawn` over gloo, each a process of its
own, held to the same training run in one process without a process
group, as tests/test_parallel.py holds the JAX package's mesh to its
one-device mesh.

Tolerances: the loss of one step to rel 1e-4 (JAX's dryrun criterion:
the ranks' sums reassociate float sums); parameters after Adam to 1e-5
(Adam's first step moves each weight by about lr times the sign of its
gradient, so a rounding of the summed gradient moves it by lr times that
rounding over the gradient); metrics after two epochs rtol 5e-3 (JAX
test_parallel.py:104).
"""

import numpy as np
import pytest
import torch

from stove_tpu_torch import main as tmain
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.parallel import dryrun
from stove_tpu_torch.parallel import mesh as mesh_lib
from stove_tpu_torch.train.trainer import Trainer

SHRUNK = ["num_train=8", "num_test=4", "seq_len=20", "batch_size=4",
          "eval_batch=2", "encoder_channels=(8,16)", "encoder_mlp_hidden=32",
          "obj_spn_num_sums=3", "obj_spn_num_leaves=3",
          "obj_spn_repetitions=2", "obj_spn_depth=1", "bg_spn_num_sums=2",
          "bg_spn_num_leaves=2", "bg_spn_depth=2", "bg_spn_repetitions=1",
          "dyn_hidden=32", "cl=4", "debug=true", "nolog=true",
          "eval_every=99", "ckpt_every=99"]


def _cfg(preset, tmp_path, *extra):
    return tmain.build_config([f"preset={preset}", *SHRUNK,
                               f"data_dir={tmp_path / 'data'}",
                               f"run_dir={tmp_path / 'runs'}", *extra])[0]


def _train(rank, device, cfg_json, epochs):
    """A rank's run: `epochs` epochs of the Trainer; its metrics and
    parameters."""
    trainer = Trainer(Config.from_json(cfg_json), device=device)
    metrics = [trainer.train_epoch(e) for e in range(epochs)]
    return {"metrics": metrics, "mesh": trainer.mesh,
            "params": [p.detach().clone() for p in
                       tree.leaves(trainer.params)]}


def _restore(rank, device, cfg_json):
    """A rank's Trainer restored from a run; its parameters, step and
    start epoch, then one step."""
    trainer = Trainer(Config.from_json(cfg_json), device=device)
    out = {"params": [p.detach().clone() for p in
                      tree.leaves(trainer.params)],
           "step": trainer.step, "start_epoch": trainer.start_epoch}
    trainer.train_epoch(trainer.start_epoch)
    out["after"] = [p.detach().clone() for p in tree.leaves(trainer.params)]
    return out


def _one_process(cfg, epochs):
    return _train(0, torch.device("cpu"), cfg.to_json(), epochs)


def _hold(got, want, loss_rtol=1e-4, param_atol=1e-5, metric_rtol=None):
    for g, w in zip(got["metrics"], want["metrics"]):
        if metric_rtol is None:
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol)
        else:
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=metric_rtol,
                                           atol=1e-5, err_msg=k)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=param_atol)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("shape,axes,world,want", [
    ((0,), ("data",), 1, (1,)), ((0,), ("data",), 8, (8,)),
    ((4,), ("data",), 8, (4,)), ((0, 2), ("data", "model"), 8, (4, 2)),
    ((4, 2), ("data", "model"), 8, (4, 2))])
def test_mesh_shape_resolution(shape, axes, world, want):
    cfg = Config(mesh_shape=shape, mesh_axes=axes)
    mesh = mesh_lib.make_mesh(cfg, (0, world))
    assert mesh.shape == want and mesh.axes == axes and mesh.world == world
    if shape == (0,):                                   # no process group
        assert mesh_lib.make_mesh(cfg) == mesh_lib.Mesh((1,), axes, 0, 1)


def test_mesh_larger_than_the_world_raises():
    with pytest.raises(ValueError, match="torch.distributed.run"):
        mesh_lib.make_mesh(Config(mesh_shape=(2,)))
    with pytest.raises(ValueError, match="differ"):
        mesh_lib.make_mesh(Config(mesh_shape=(2, 2), mesh_axes=("data",)),
                           (0, 4))


@pytest.mark.parametrize("size,batch,want", [(8, 8, 8), (8, 12, 6),
                                             (3, 4, 2), (5, 7, 1),
                                             (4, 256, 4)])
def test_largest_divisor_of_the_batch(size, batch, want):
    mesh = mesh_lib.Mesh((size,), ("data",), 0, size)
    got = mesh_lib.for_batch(mesh, batch)
    assert got.size == want
    assert [mesh_lib.for_batch(mesh._replace(rank=r), batch).active
            for r in range(size)] == [r < want for r in range(size)]


def test_rows_and_shares_of_a_second_axis():
    """(4, 2) ('data', 'model'): ranks 2i and 2i + 1 hold data block i
    (the 'model' axis replicates), each weighted by half its block's
    share; a rank beyond the mesh holds nothing."""
    rows, shares = [], []
    for r in range(8):
        m = mesh_lib.Mesh((4, 2), ("data", "model"), r, 9)
        rows.append(m.rows(16))
        shares.append(m.share(16))
    assert rows == [slice(4 * (r // 2), 4 * (r // 2) + 4) for r in range(8)]
    assert shares == [0.125] * 8 and sum(shares) == 1.0
    out = mesh_lib.Mesh((4, 2), ("data", "model"), 8, 9)
    assert not out.active and out.rows(16) == slice(0, 0)
    assert out.share(16) == 0.0


def test_shard_replicate_and_pad():
    x = torch.arange(16.0).reshape(8, 2)
    m = mesh_lib.Mesh((4,), ("data",), 2, 4)
    a, none = mesh_lib.shard_batch(m, [x, None], 8)
    assert torch.equal(a, x[4:6]) and none is None
    y = x.clone()
    mesh_lib.replicate([y])                     # no group: the identity
    assert torch.equal(y, x)
    assert mesh_lib.all_reduce_sum([x])[0] is x
    padded, n = mesh_lib.pad_to_multiple(torch.ones(5, 2), 8)
    assert padded.shape == (8, 2) and n == 5 and padded[5:].sum() == 0
    same, n = mesh_lib.pad_to_multiple(x, 4)
    assert same is x and n == 8
    assert mesh_lib.backend_for(torch.device("cpu")) == "gloo"
    assert mesh_lib.backend_for(torch.device("cuda")) == "nccl"


# ------------------------------------------------------------ ranks

@pytest.mark.parametrize("preset,extra", [
    ("stove_billiards", ()),
    ("stove_avoidance", ("reward_pos_rate=-1",))],
    ids=["billiards", "avoidance-batch-rate"])
def test_two_ranks_step_equals_one_rank(preset, extra, tmp_path):
    """One ELBO step at two ranks equals the step in one process: loss rel
    1e-4, parameters after Adam 1e-5.  With reward_pos_rate=-1 the
    balanced reward BCE weighs its classes by the batch's reward rate;
    a rank that took its own shard's rate would compute another loss."""
    cfg = _cfg(preset, tmp_path, "num_epochs=1", "steps_per_epoch=1",
               "supair_only_epochs=0", *extra)
    want = _one_process(cfg, 1)
    outs = dryrun.spawn(_train, 2, cfg.to_json(), 1)
    for out in outs:
        assert out["mesh"].size == 2
        _hold(out, want)
    if preset == "stove_avoidance":
        assert cfg.reward_pos_rate == -1.0
        np.testing.assert_allclose(outs[0]["metrics"][0]["reward_loss"],
                                   want["metrics"][0]["reward_loss"],
                                   rtol=1e-4)


def test_two_epochs_at_two_ranks_match_one_rank(tmp_path):
    """A SuPAIR warm-up epoch and an ELBO epoch, two steps each: every
    logged metric within rtol 5e-3 of the one-process run's
    (test_parallel.py:104), the parameters within 1e-5."""
    cfg = _cfg("stove_billiards", tmp_path, "num_epochs=2",
               "steps_per_epoch=2", "supair_only_epochs=1")
    want = _one_process(cfg, 2)
    for out in dryrun.spawn(_train, 2, cfg.to_json(), 2):
        _hold(out, want, metric_rtol=5e-3)


def test_ranks_beyond_the_divisor_sit_out(tmp_path):
    """Three ranks, a batch of 4: the step runs on the first two (two
    windows each), the third sits it out, and all three end with the
    one-process run's parameters; a (1, 2) ('data', 'model') mesh
    replicates the whole batch on both of its ranks likewise."""
    cfg = _cfg("stove_billiards", tmp_path, "num_epochs=1",
               "steps_per_epoch=1", "supair_only_epochs=0")
    want = _one_process(cfg, 1)
    outs = dryrun.spawn(_train, 3, cfg.to_json(), 1)
    assert [o["mesh"].active for o in outs] == [True, True, False]
    for out in outs:
        _hold(out, want)
    rep = cfg.with_overrides(mesh_shape=(1, 2), mesh_axes=("data", "model"))
    for out in dryrun.spawn(_train, 2, rep.to_json(), 1):
        assert out["mesh"].shape == (1, 2)
        _hold(out, want)


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2)
    assert out["rel"] < 1e-4 and np.isfinite(out["loss"])


def test_restore_under_two_ranks(tmp_path):
    """A run written by one process resumes on two ranks: each loads the
    checkpoint (step, epoch, parameters), and their next epoch keeps the
    parameters equal across the ranks and to the one-process resume's."""
    cfg = _cfg("stove_billiards", tmp_path, "num_epochs=1",
               "steps_per_epoch=1", "supair_only_epochs=0", "nolog=false",
               "ckpt_every=1")
    first = Trainer(cfg, device="cpu")
    first.train()
    saved = [p.detach().clone() for p in tree.leaves(first.params)]
    resume = cfg.with_overrides(restore=first.run_dir, num_epochs=2,
                                nolog=True)
    want = _restore(0, torch.device("cpu"), resume.to_json())
    outs = dryrun.spawn(_restore, 2, resume.to_json())
    for out in outs:
        assert out["step"] == first.step and out["start_epoch"] == 1
        for a, b in zip(out["params"], saved):
            assert torch.equal(a, b)
        for a, b, c in zip(out["after"], outs[0]["after"], want["after"]):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                       atol=1e-5)
