"""The slice end to end: the port's eval against the JAX eval on one
corpus, and the port's guard rails.

Frames and ground truth come from the JAX physics at the same initial
states; both evaluations restore ckpts/r4rp_bill_s32 and the port gets the
posterior normals JAX draws.  The metrics are means over the batch of
squared position errors after an 8-step (or 20-step) chaotic rollout, so
they are held to rtol 1e-4 (mse) and atol 1e-6 (in-frame share, speed
ratio differences of a few float32 ulps in the mean).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.train import evaluate as jeval
from stove_tpu_torch import main as tmain
from stove_tpu_torch.device import resolve_device
from stove_tpu_torch.envs.data import Episode
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.train import checkpoint as ckpt
from stove_tpu_torch.train import evaluate as teval
from torch_parity import jax_infer_noise

RUN = "ckpts/r4rp_bill_s32"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    tcfg = ckpt.load_config(RUN).with_overrides(seq_len=30, eval_batch=8)
    jcfg = JConfig.from_json(tcfg.to_json())
    model = StoveModel.from_run(RUN, cfg=tcfg, device="cpu")
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()),
                                     {"supair": {"encoder": model.params[
                                         "supair"]["encoder"]},
                                      "dynamics": model.params["dynamics"]})
    jep = jdata.generate(jcfg, 8, jax.random.key(21))
    tep = Episode(*(torch.from_numpy(np.array(a)) for a in jep))
    tep = tep._replace(actions=tep.actions.long())
    return jcfg, JModel(jcfg), jparams, jep, model, tep


def _close(got, want, rtol, atol):
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_rollout_metrics_match_jax(setup):
    jcfg, jmodel, jparams, jep, model, tep = setup
    key = jax.random.key(0)
    want = jeval.rollout_metrics(jmodel, jparams, jep, key)
    k_inf, _ = jax.random.split(key)
    got = teval.rollout_metrics(
        model, tep, noise=jax_infer_noise(k_inf, jcfg, 8, jcfg.window))
    assert set(got) == set(want)
    _close(got, want, rtol=1e-4, atol=1e-7)
    _close(teval.baseline_metrics(model.cfg, tep),
           jeval.baseline_metrics(jcfg, jep), rtol=1e-6, atol=1e-7)


def test_longhorizon_mean_metrics_match_jax(setup):
    jcfg, jmodel, jparams, jep, model, tep = setup
    key = jax.random.key(1)
    want = jeval.longhorizon_metrics(jmodel, jparams, jep, key, t_pred=20,
                                     batch=8)
    k_inf, _ = jax.random.split(key)
    got = teval.longhorizon_metrics(
        model, tep, t_pred=20, batch=8,
        noise=jax_infer_noise(k_inf, jcfg, 8, jcfg.window))
    assert int(got["horizon"]) == int(want["horizon"])
    _close(got, want, rtol=1e-4, atol=1e-6)


def test_main_eval_on_cpu_prints_the_jax_keys(capsys, tmp_path):
    assert tmain.main([f"restore={RUN}", "mode=eval", "device=cpu",
                       "eval_batch=4", "seq_len=90",
                       f"data_dir={tmp_path}"]) == 0
    keys = {line.split(":")[0] for line in capsys.readouterr().out.splitlines()
            if ":" in line}
    want = {"mse_per_step", "mse_mean", "mse_final", "detect_mse",
            "handoff_vel_rms", "linear_mse_per_step", "linear_mse_final",
            "frozen_mse_per_step", "frozen_mse_final"}
    for prefix in ("longhorizon_", "longhorizon_sampled_"):
        want |= {prefix + k for k in ("horizon", "frac_in_frame",
                                      "speed_ratio")}
    assert keys == want


def test_other_modes_are_not_ported():
    """Every mode of the JAX CLI is served (tests/test_torch_profile.py
    drives generate, viz and profile); the CLI refuses only a mode the JAX
    CLI does not have, and mode=viz, as mode=eval, without a run to
    restore."""
    with pytest.raises(SystemExit, match="unknown mode 'render'"):
        tmain.main([f"restore={RUN}", "mode=render", "device=cpu"])
    for mode in ("viz", "eval"):
        with pytest.raises(SystemExit, match=f"mode={mode} requires restore"):
            tmain.main(["preset=stove_billiards", f"mode={mode}",
                        "device=cpu"])


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StoveModel.from_run(RUN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main([f"restore={RUN}", "mode=eval"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load_params(RUN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.params_from_numpy({"w": np.ones(2)})
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_device_turns_tf32_off(monkeypatch):
    """The entry points compute in IEEE float32 on the card: picking a CUDA
    device turns TF32 off for cuBLAS and cuDNN (chip_smoke.py checks the
    same after its mode=eval run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "stove_tpu_torch").rglob("*.py")]
    + [pathlib.Path("chip_smoke.py")]), ids=str)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "stove_tpu", "flax", "optax"), \
            f"{path} imports {name}"
