"""Training machinery of the port against `stove_tpu/train/`: the optimizer
against optax, the checkpoint layout against the JAX trainer's, and a
`debug_shrunk` training run through the entry point on the CPU.

Tolerances: one Adam step is elementwise float32 arithmetic in both
(rtol 1e-6, atol 1e-7 on parameters of O(1) after three steps); counts and
checkpoint round trips are exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models.bundle import StoveModel as JStoveModel
from stove_tpu.train import checkpoint as jckpt
from stove_tpu.train import trainer as jtrainer
from stove_tpu_torch import main as tmain
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.train import checkpoint as tckpt
from stove_tpu_torch.train import trainer as ttrainer

RUN = "ckpts/r4rp_bill_s32"
SHRUNK = ["num_train=8", "num_test=4", "seq_len=20", "batch_size=4",
          "num_epochs=2", "eval_batch=2", "encoder_channels=(8,16)",
          "encoder_mlp_hidden=32", "obj_spn_num_sums=3",
          "obj_spn_num_leaves=3", "obj_spn_repetitions=2", "obj_spn_depth=1",
          "bg_spn_num_sums=2", "bg_spn_num_leaves=2", "bg_spn_depth=2",
          "bg_spn_repetitions=1", "dyn_hidden=32", "cl=4",
          "supair_only_epochs=1", "steps_per_epoch=2", "debug=true"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(rng):
    return {"supair": {"a": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": [rng.normal(size=(5,)).astype(np.float32)]},
            "dynamics": {"c": rng.normal(size=(2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip,shape", [(1e3, "linear"), (0.5, "linear"),
                                        (0.5, "cosine"), (0.5, None)],
                         ids=["no-clip", "clip-linear", "clip-cosine",
                              "clip-constant"])
def test_optimizer_step_matches_optax(clip, shape):
    kw = dict(grad_clip=clip, supair_lr=0.01, dynamics_lr=0.003,
              adam_b1=0.8, adam_b2=0.99, num_epochs=2, steps_per_epoch=2)
    kw.update(dict(debug_anneal_lr=3.0, anneal_shape=shape,
                   anneal_final=0.1) if shape else dict(debug_anneal_lr=0.0))
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    tp = tree.map_leaves(_t, _tree(np.random.default_rng(0)))
    jopt = jtrainer.make_optimizer(jc)
    jstate = jopt.init(jp)
    topt = ttrainer.Optimizer(tc)
    tstate = topt.init(tp)
    for step in range(4):
        grads = _tree(rng)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update(tp, tree.map_leaves(_t, grads), tstate)
        np.testing.assert_allclose(norm, optax.global_norm(jg), rtol=1e-6)
        for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    flat = tckpt.flatten_state(tp, tstate, 0)
    want = jckpt._flatten({"opt_state": jstate})
    assert set(want) == {k for k in flat if k.startswith("['opt_state']")}
    for k, v in want.items():
        np.testing.assert_allclose(flat[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert int(tstate["supair"]["count"]) == 4


def test_clip_is_optax_not_clip_grad_norm():
    """At a norm just above the limit optax scales by max/norm exactly;
    torch's clip_grad_norm_ divides by norm + 1e-6."""
    tc = TConfig(grad_clip=1.0, debug_anneal_lr=0.0, supair_lr=1.0,
                 dynamics_lr=1.0, adam_b1=0.0, adam_b2=0.0)
    g = {"supair": {"a": torch.tensor([0.6, 0.8000001])},
         "dynamics": {"c": torch.tensor([0.0])}}
    p = tree.map_leaves(torch.zeros_like, g)
    opt = ttrainer.Optimizer(tc)
    st = opt.init(p)
    opt.update(p, g, st)
    jc = JConfig(grad_clip=1.0)
    jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), g)
    clipped, _ = optax.clip_by_global_norm(jc.grad_clip).update(jg, None)
    np.testing.assert_array_equal(st["supair"]["mu"]["a"], clipped["supair"]["a"])


def _jax_template(jc):
    model = JStoveModel(jc)
    params = model.init_params()
    return {"params": params,
            "opt_state": jtrainer.make_optimizer(jc).init(params),
            "key": jax.random.key_data(jax.random.key(0)),
            "epoch": np.int32(0)}


def test_port_checkpoint_restores_in_jax(tmp_path):
    tc = tmain.build_config(["preset=stove_billiards", *SHRUNK,
                             f"run_dir={tmp_path}",
                             f"data_dir={tmp_path / 'data'}"])[0]
    tr = ttrainer.Trainer(tc, device="cpu")
    tr.train_epoch(0)
    tr.train_epoch(1)
    tr.save(1)
    jc = JConfig.from_json(tc.to_json())
    step, loaded = jckpt.restore(tr.run_dir, _jax_template(jc))
    assert step == tr.step == 4
    for a, b in zip(tree.leaves(tr.params),
                    jax.tree_util.tree_leaves(loaded["params"])):
        np.testing.assert_array_equal(a.detach(), b)
    jstate = loaded["opt_state"][1].inner_states
    for g in ("supair", "dynamics"):
        adam, sched = jstate[g].inner_state
        assert int(adam.count) == int(sched.count) == 4
        for a, b in zip(tree.leaves(tr.opt_state[g]["mu"]),
                        jax.tree_util.tree_leaves(adam.mu)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tree.leaves(tr.opt_state[g]["nu"]),
                        jax.tree_util.tree_leaves(adam.nu)):
            np.testing.assert_array_equal(a, b)
    assert int(loaded["epoch"]) == 1
    # and back into the port
    tr2 = ttrainer.Trainer(tc.with_overrides(restore=tr.run_dir,
                                             run_dir=str(tmp_path / "b")),
                           device="cpu")
    assert (tr2.step, tr2.start_epoch) == (4, 2)
    for a, b in zip(tree.leaves(tr2.params), tree.leaves(tr.params)):
        np.testing.assert_array_equal(a.detach(), b.detach())


def test_restore_of_the_committed_run():
    step, params, opt_state, epoch = tckpt.restore(RUN, device="cpu")
    assert (step, epoch) == (7200, 359)
    with np.load(f"{RUN}/ckpt_00007200.npz") as z:
        for g in ("supair", "dynamics"):
            for k in (0, 1):
                key = (f"['opt_state'][1].inner_states['{g}']"
                       f".inner_state[{k}].count")
                assert int(z[key]) == 7200
            assert int(opt_state[g]["count"]) == 7200
            assert int(opt_state[g]["lr_count"]) == 7200
        w = z["['opt_state'][1].inner_states['dynamics'].inner_state[0]"
              ".nu['dynamics']['embed'][0]['w']"]
        np.testing.assert_array_equal(opt_state["dynamics"]["nu"]["embed"][0]
                                      ["w"], w)
        np.testing.assert_array_equal(
            params["supair"]["bg_spn"]["leaf_mu"],
            z["['params']['supair']['bg_spn']['leaf_mu']"])


def test_debug_train_run_through_the_entry_point(tmp_path):
    argv = ["preset=stove_billiards", *SHRUNK, "scan_impl=pallas",
            "likelihood_impl=pallas", "eval_every=1", f"run_dir={tmp_path}",
            f"data_dir={tmp_path / 'data'}", "device=cpu"]
    assert tmain.main(argv) == 0
    run = tmp_path / "stove_bil"
    rows = [json.loads(ln) for ln in open(run / "metrics.jsonl")]
    train = [r for r in rows if r["kind"] == "train"]
    assert [r["warmup"] for r in train] == [True, False]
    assert [r["step"] for r in train] == [2, 4]
    assert set(train[0]) >= {"loss", "supair_ll", "mean_scale"}
    assert set(train[1]) >= {"loss", "elbo", "log_lik", "kl", "overshoot",
                             "grad_norm", "reward_loss", "open_sigma_nll"}
    assert all(np.isfinite(r["loss"]) for r in train)
    assert {r["kind"] for r in rows} == {"train", "eval", "baseline"}
    assert (run / "ckpt_00000004.npz").exists()
    assert json.load(open(run / "spn_seeds.json"))["obj"]
    assert {p.name for p in run.glob("*.gif")} == {"rollout_ep0000.gif",
                                                  "rollout_ep0001.gif"}


def test_trainer_refuses_what_it_does_not_do(tmp_path):
    tc = tmain.build_config(["preset=stove_billiards", *SHRUNK])[0]
    # a mesh larger than the world (one process, no torch.distributed.run)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        ttrainer.Trainer(tc.with_overrides(mesh_shape=(2,)), device="cpu")
    with pytest.raises(ValueError, match="committed checkpoint store"):
        ttrainer.Trainer(tc.with_overrides(run_dir="ckpts"), device="cpu")


def test_sample_windows():
    tc = TConfig(seq_len=12, num_obj=3)
    ep = tdata.generate(tc, 5, torch.Generator().manual_seed(0))
    b = tdata.sample_windows(ep, tc, torch.Generator().manual_seed(1), 7)
    assert b["frames"].shape == (7, tc.window, 32, 32)
    assert b["frames"].dtype == torch.float32
    assert 0 <= float(b["frames"].min()) and float(b["frames"].max()) <= 1
    assert b["states"].shape == (7, tc.window, 3, 4)
    # every window is a contiguous run of one sequence
    found = 0
    for w in b["states"]:
        for n in range(5):
            for o in range(12 - tc.window + 1):
                if torch.equal(ep.states[n, o:o + tc.window], w):
                    found += 1
                    break
    assert found == 7
