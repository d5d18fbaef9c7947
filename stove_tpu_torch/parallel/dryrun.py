"""One data-parallel training step over n ranks, held to the one-device
step (counterpart of `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n)` spawns n ranks (`spawn`: torch.multiprocessing, a
process group with the device's backend or the one named); each builds
the Trainer at `Config().debug_shrunk()` with `encoder_space_to_depth=2`
(the preset's encoder path) and a batch of one window a rank, and runs one full training step -- the ELBO gradient on
its window, the all-reduce, the clip and Adam -- on frames drawn from a
seeded generator.  Each rank also computes the loss of the whole batch on
one device, with the same parameters and noise and no sharding; the
sharded loss must equal it to rel 1e-4, JAX's criterion (cross-rank sums
reassociate float sums).  At n = 1 the rank also runs the same step
without a process group, and its loss and parameters must equal the
group's bit for bit.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.parallel import mesh as mesh_lib


def _entry(rank: int, fn: Callable, n: int, address: str, device: str,
           backend: Optional[str], out_dir: str, args: tuple) -> None:
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # one card a rank while there are cards enough (NCCL's rule);
        # beyond, the ranks share them (gloo)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    mesh_lib.init_process_group(dev, rank, n, address, backend)
    try:
        out = fn(rank, dev, *args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, n: int, *args, device: str = "cpu",
          backend: Optional[str] = None) -> List:
    """Run `fn(rank, device, *args)` in n spawned ranks of one process
    group (`backend` or the device's) and return each rank's result
    (picklable), in rank order; on CUDA rank r takes card r modulo the
    cards there are.  The ranks meet through a file in a temporary
    directory, not a TCP port another process could hold.  `fn` must be
    importable by name."""
    with tempfile.TemporaryDirectory() as out_dir:
        address = f"file://{os.path.join(out_dir, 'rendezvous')}"
        torch.multiprocessing.spawn(
            _entry, args=(fn, n, address, device, backend, out_dir, args),
            nprocs=n, join=True)
        results = []
        for rank in range(n):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _all_reduce_probe(rank: int, device: torch.device):
    """The sum over the ranks of a tensor on `device`, or the error the
    backend's all_reduce raised for it."""
    x = torch.full((4,), float(rank + 1), device=device)
    try:
        torch.distributed.all_reduce(x)
    except RuntimeError as e:    # the backend refuses the device's tensors
        return f"{type(e).__name__}: {e}"
    return x.cpu().tolist()


def backend_refuses(device: str, backend: str, n: int = 2) -> Optional[str]:
    """Whether `backend` all-reduces tensors on `device` over n ranks (on
    one card, they share it): None when it does, else the error its
    all_reduce gave.  (gloo's CUDA support depends on how torch was
    built.)"""
    outs = spawn(_all_reduce_probe, n, device=device, backend=backend)
    refused = [o for o in outs if isinstance(o, str)]
    if refused:
        return refused[0]
    want = [float(n * (n + 1) // 2)] * 4
    if any(o != want for o in outs):
        raise AssertionError(f"{backend} all_reduce on {device}: {outs}, "
                             f"expected {want}")
    return None


def tiny_config(n: int, data_dir: str) -> Config:
    """The dry run's config: debug_shrunk with the preset's
    space-to-depth encoder, one window a rank, no run directory."""
    return Config().debug_shrunk().with_overrides(
        encoder_space_to_depth=2, batch_size=n, nolog=True,
        data_dir=data_dir, supair_only_epochs=0)


def _step(n: int, device: torch.device, data_dir: str) -> Dict:
    """One Trainer step on the dry run's batch; the batch's loss and the
    loss of the same batch on one device before it."""
    from stove_tpu_torch.models import stove as stove_lib
    from stove_tpu_torch.train.trainer import Trainer

    trainer = Trainer(tiny_config(n, data_dir), device=device)
    cfg = trainer.cfg
    frames = torch.rand((n, cfg.window, cfg.img_size, cfg.img_size),
                        generator=torch.Generator().manual_seed(2)
                        ).to(device)
    twin = torch.Generator(trainer.noise_gen.device).set_state(
        trainer.noise_gen.get_state())
    with torch.no_grad():
        noise = stove_lib.draw_elbo_noise(cfg, n, cfg.window, twin, device)
        whole = float(trainer.model.elbo(trainer.params, frames, None, None,
                                         noise).loss)
    loss = float(trainer.train_step({"frames": frames})["loss"])
    return {"loss": loss, "loss_1dev": whole,
            "params": [p.detach().cpu() for p in tree.leaves(trainer.params)]}


def _rank(rank: int, device: torch.device, n: int, data_dir: str) -> Dict:
    out = _step(n, device, data_dir)
    if n == 1:
        torch.distributed.destroy_process_group()
        plain = _step(1, device, data_dir)
        out["bitwise"] = (out["loss"] == plain["loss"] and all(
            torch.equal(a, b) for a, b in zip(out["params"],
                                              plain["params"])))
    return out


def train_epochs(rank: int, device: torch.device, cfg_json: str,
                 epochs: int) -> Dict:
    """A Trainer's first `epochs` epochs (`train_epoch`; no evaluation,
    no checkpoint), as one of `spawn`'s ranks or alone (rank 0): every
    step's metrics row by epoch ((steps, M) each) and keys, the parameter
    leaves and then the optimizer state leaves after them ("state", the
    first "n_params" the parameters), all on the CPU; whether its epochs
    were fused, and the step kinds it captured as CUDA graphs.  A harness
    of the tests and chip_smoke.py, kept here beside `spawn` because a
    spawned rank runs a module-level function."""
    from stove_tpu_torch.train.trainer import Trainer

    trainer = Trainer(Config.from_json(cfg_json), device=device)
    rows, keys = [], []
    for e in range(epochs):
        trainer.train_epoch(e)
        keys.append(tuple(trainer.epoch_metrics[0]))
        rows.append(torch.stack([torch.stack(list(m.values()))
                                 for m in trainer.epoch_metrics]).cpu())
    params = tree.leaves(trainer.params)
    return {"rows": rows, "keys": keys, "n_params": len(params),
            "state": [x.detach().cpu().clone() for x in
                      params + tree.leaves(trainer.opt_state)
                      if x is not None],
            "fused": trainer._use_fused(), "captured": sorted(trainer._graphs),
            "step": trainer.step}


def dryrun_multichip(n: int, device: str = "cpu",
                     backend: Optional[str] = None) -> Dict:
    """One training step over n ranks on `device` ("cpu": gloo; "cuda":
    NCCL, one card a rank, or `backend="gloo"` for ranks sharing one
    card); raises unless the sharded loss is finite and equals the
    one-device loss to rel 1e-4 on every rank, and the ranks' parameters
    after the step are equal (and at n = 1 equal bit for bit to the step
    without a process group).  Returns rank 0's loss, one-device loss,
    relative difference and, at n = 1, `bitwise`."""
    with tempfile.TemporaryDirectory() as data_dir:
        outs = spawn(_rank, n, n, data_dir, device=device, backend=backend)
    for r, out in enumerate(outs):
        if not torch.isfinite(torch.tensor(out["loss"])):
            raise AssertionError(f"rank {r}: non-finite loss {out['loss']}")
        rel = abs(out["loss"] - out["loss_1dev"]) / max(
            1.0, abs(out["loss_1dev"]))
        if rel >= 1e-4:
            raise AssertionError(
                f"rank {r}: sharded loss {out['loss']} != single-device "
                f"loss {out['loss_1dev']} (rel {rel:.2e})")
        if not all(torch.equal(a, b) for a, b in zip(out["params"],
                                                     outs[0]["params"])):
            raise AssertionError(f"rank {r}'s parameters differ from rank "
                                 "0's after the step")
    if n == 1 and not outs[0]["bitwise"]:
        raise AssertionError("the step in a process group of one differs "
                             "from the step without one")
    out = outs[0]
    rel = abs(out["loss"] - out["loss_1dev"]) / max(1.0,
                                                   abs(out["loss_1dev"]))
    print(f"dryrun_multichip({n}): loss={out['loss']:.3f} (matches "
          f"1-device {out['loss_1dev']:.3f}, rel {rel:.2e}) ok")
    return {"loss": out["loss"], "loss_1dev": out["loss_1dev"], "rel": rel,
            "bitwise": out.get("bitwise")}
