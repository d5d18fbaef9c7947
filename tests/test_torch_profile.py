"""The CLI modes the port added last: `mode=profile`, `mode=generate` and
`mode=viz`, on the CPU (`device=cpu`), every file under `tmp_path`.

* profile: on a shrunk preset through the kernel dispatches, a Chrome
  trace that parses, holds the three traced steps' annotations and their
  operators, and no device event on the CPU
  (`utils/profiling.device_times`).
* generate: both splits written under `data_dir`, as `split()` makes them,
  and the JAX CLI's lines printed.
* viz: on ckpts/r4rp_bill_s32, `rollout_viz.gif` (eval_rollout_steps
  frames of true | predicted, 264 x 128) and `detect_grid.png` written
  under `<run_dir>/<run_name>`, nothing into the restored directory; a
  run dir inside `ckpts/` is refused.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stove_tpu_torch import main as tmain
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.train import visualize as tviz
from stove_tpu_torch.utils import profiling

RUN = "ckpts/r4rp_bill_s32"
SHRUNK = ["num_train=8", "num_test=4", "seq_len=20", "batch_size=4",
          "num_epochs=2", "eval_batch=2", "encoder_channels=(8,16)",
          "encoder_mlp_hidden=32", "obj_spn_num_sums=3",
          "obj_spn_num_leaves=3", "obj_spn_repetitions=2", "obj_spn_depth=1",
          "bg_spn_num_sums=2", "bg_spn_num_leaves=2", "bg_spn_depth=2",
          "bg_spn_repetitions=1", "dyn_hidden=32", "cl=4",
          "supair_only_epochs=1", "steps_per_epoch=2", "debug=true"]


def test_profile_mode_writes_a_trace(tmp_path, capsys):
    assert tmain.main(["mode=profile", "preset=stove_billiards", *SHRUNK,
                       "scan_impl=pallas", "likelihood_impl=pallas",
                       "spn_impl=pallas", f"run_dir={tmp_path / 'r'}",
                       f"data_dir={tmp_path / 'd'}", "device=cpu"]) == 0
    trace_dir = tmp_path / "r" / "stove_bil" / "trace"
    assert f"trace written to {trace_dir}" in capsys.readouterr().out
    path = trace_dir / profiling.TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {f"train_step_{i}" for i in range(3)} <= names
    assert any(e.get("cat") == "cpu_op" for e in events)
    device, wall = profiling.device_times(str(path))
    assert device == {} and wall > 0


def test_generate_mode_writes_both_splits(tmp_path, capsys):
    argv = ["mode=generate", "preset=stove_gravity", "num_train=3",
            "num_test=2", "seq_len=6", f"data_dir={tmp_path}", "device=cpu"]
    assert tmain.main(argv) == 0
    cfg = tmain.build_config(argv)[0]
    out = capsys.readouterr().out.splitlines()
    for split, n in (("train", 3), ("test", 2)):
        path = tdata.dataset_path(cfg, split)
        assert f"{split}: frames ({n}, 6, 32, 32) -> {path}" in out
        for a, b in zip(tdata.load(path), tdata.split(cfg, split)):
            assert torch.equal(a, b)
    assert len(os.listdir(tmp_path)) == 2


def test_viz_mode_writes_the_gif_and_the_grid(tmp_path, capsys):
    before = sorted(os.listdir(RUN))
    assert tmain.main([f"restore={RUN}", "mode=viz", "device=cpu",
                       f"run_dir={tmp_path / 'r'}",
                       f"data_dir={tmp_path / 'd'}"]) == 0
    out_dir = tmp_path / "r" / "r4rp_bill_s32"
    gif, grid = out_dir / "rollout_viz.gif", out_dir / "detect_grid.png"
    assert capsys.readouterr().out.split() == ["wrote", str(gif), "wrote",
                                               str(grid)]
    info = tviz.read_gif_info(str(gif))
    assert (info["frames"], info["width"], info["height"]) == (8, 264, 128)
    assert info["delays_cs"] == [12] * 8 and info["loop"] == 0
    im = Image.open(grid)
    assert im.size == (8 * 128 + 7 * 4, 128)
    assert np.asarray(im.convert("RGB")).std() > 0
    assert sorted(os.listdir(RUN)) == before


def test_viz_mode_refuses_the_committed_store(tmp_path):
    with pytest.raises(ValueError, match="committed checkpoint store"):
        tmain.main([f"restore={RUN}", "mode=viz", "device=cpu",
                    "run_dir=ckpts", f"data_dir={tmp_path}"])
    assert not os.path.exists(os.path.join("ckpts", "r4rp_bill_s32",
                                           "rollout_viz.gif"))
