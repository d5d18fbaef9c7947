"""SuPAIR: box encoding, the SPN likelihood and the SuPAIR-only ELBO.

Counterpart of `stove_tpu/models/supair.py`.  The encoder proposes
q(z_where | x) per object; the likelihood scores

    log p(x | z_where) = Σ_o log SPN_obj(patch_o, w_o) + log SPN_bg(x, w_bg)

with patch-space overlap weights (`overlap_impl="patch"`) or the
image-space ones (`"image"`, `image_weights`).  Dispatch, as
supair.py:149-241 does: `likelihood_impl="pallas"` sends the whole
likelihood to `fused_likelihood.likelihood_fused` (the CUDA kernel on the
card; it has the patch-space weights only, and raises the reference's
ValueError for the image-space ones before anything runs); otherwise the
glimpses and weights run as plain tensor code and the two SPNs go to the
dense `spn.spn_log_prob` (`spn_impl="dense"`), to
`spn.spn_log_prob_matmul` (`"matmul"`) or to
`fused_spn.spn_log_prob_fused` (`"pallas"`).  The reference's fallback
from `pallas` to `matmul` where Pallas is missing is not ported: the port
launches its kernel or raises.

The RAT-SPN region graphs come from one permutation seed per repetition
(`spec_seeds`).  The reference draws them with `jax.random` from the run's
seed (spn.py:65-79); the port keeps those draws for the seeds of the
committed run directories in `JAX_SPEC_SEEDS` (held against JAX by
tests/test_torch_spn.py), reads its own runs' seeds from `spn_seeds.json`
beside their checkpoints, and draws a fresh run's from a torch.Generator.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import encoder as encoder_lib
from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.ops import fused_likelihood, fused_spn, gaussians
from stove_tpu_torch.ops import glimpse

SEEDS_FILE = "spn_seeds.json"

# (cfg.seed, obj_spn_repetitions, bg_spn_repetitions) -> (object SPN seeds,
# background SPN seeds), as the JAX package draws them: supair.make_specs'
# split of jax.random.key(seed), then jax.random.randint(k, (R,), 0, 2**31-1).
JAX_SPEC_SEEDS: Dict[Tuple[int, int, int], Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    (0, 4, 2): ((447923887, 1477415817, 562929823, 1332000890), (390137614, 1555671686)),
    (2, 4, 2): ((1566417524, 1822728076, 2058623687, 1486555210), (593825588, 1940685966)),
    (15, 4, 2): ((693478279, 1118848496, 805953388, 1460431108), (484342039, 2007207469)),
    (16, 4, 2): ((798442961, 668682379, 2026047569, 1443157497), (1255773383, 955872935)),
    (17, 4, 2): ((1037722910, 1446704140, 1482018585, 72752930), (435177075, 1342117842)),
    (18, 4, 2): ((1510975103, 2125617322, 928163794, 431663015), (299671427, 411341021)),
    (19, 4, 2): ((818398477, 1664075809, 764949379, 2101758981), (726684105, 1400267446)),
    (20, 4, 2): ((1605297159, 899910444, 723670366, 426636346), (1084025470, 951676306)),
    (23, 4, 2): ((1274913183, 1745404492, 1898603072, 902398990), (393299282, 1294166069)),
    (24, 4, 2): ((1299326324, 1454636222, 160974785, 1689604129), (1489443876, 1272399391)),
    (27, 4, 2): ((1864026569, 280146920, 1433308963, 529003961), (1240354446, 767437400)),
    (28, 4, 2): ((1380103684, 1282193305, 1111753282, 679700819), (1856395761, 961540736)),
    (29, 4, 2): ((1337649121, 1941646551, 825016158, 449146217), (720734216, 686501779)),
    (30, 4, 2): ((1333175076, 484438481, 1747233651, 1566881020), (297496483, 1933331902)),
    (31, 4, 2): ((271736359, 335456303, 1391656779, 1350606700), (902734540, 1528627796)),
    (32, 4, 2): ((1724523911, 97095777, 569149076, 1067226913), (1573195128, 1437628542)),
    (33, 4, 2): ((704340036, 271297208, 72731739, 447419804), (594362097, 457667060)),
    (34, 4, 2): ((132622493, 1432321779, 47328538, 1664796372), (773958279, 1939423407)),
    (35, 4, 2): ((357222863, 1505614635, 179757050, 1467322140), (1757214239, 1063883235)),
    (37, 4, 2): ((1940998425, 1789932081, 1516206812, 1878661950), (2021959171, 717817252)),
    (38, 4, 2): ((2044738334, 785541665, 1438846604, 1122703492), (582739002, 969462549)),
    (41, 4, 2): ((1539807274, 893510119, 1715876969, 1929725347), (1551474769, 786976563)),
    (43, 4, 2): ((301113541, 1383814290, 401727598, 1169490943), (1551326621, 31148930)),
    (46, 4, 2): ((1336405125, 1037258509, 1022601426, 460093889), (19418004, 1483721272)),
    (49, 4, 2): ((230135613, 661918222, 1244792164, 550515453), (1777136117, 1582105079)),
    (53, 4, 2): ((243058612, 506439476, 1663005272, 95827504), (194144105, 1011395051)),
}


class SupairSpecs(NamedTuple):
    obj: spn_lib.SpnSpec
    bg: spn_lib.SpnSpec


class SpecSeeds(NamedTuple):
    obj: Tuple[int, ...]
    bg: Tuple[int, ...]


def draw_spec_seeds(cfg: Config, generator: Optional[torch.Generator] = None
                    ) -> SpecSeeds:
    """A fresh run's permutation seeds, from `generator` (default: one
    seeded with cfg.seed)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)

    def draw(n):
        return tuple(int(s) for s in torch.randint(
            0, 2 ** 31 - 1, (n,), generator=generator))

    return SpecSeeds(draw(cfg.obj_spn_repetitions),
                     draw(cfg.bg_spn_repetitions))


def run_spec_seeds(run_dir: str, cfg: Config) -> SpecSeeds:
    """The seeds a run directory's weights were trained with: the port's
    `spn_seeds.json`, else the JAX package's draw for the run's seed."""
    path = os.path.join(run_dir, SEEDS_FILE)
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        return SpecSeeds(tuple(raw["obj"]), tuple(raw["bg"]))
    key = (cfg.seed, cfg.obj_spn_repetitions, cfg.bg_spn_repetitions)
    if key not in JAX_SPEC_SEEDS:
        raise KeyError(
            f"{run_dir} has no {SEEDS_FILE} and (seed, obj reps, bg reps) = "
            f"{key} is not in JAX_SPEC_SEEDS: its SPN region graphs are "
            "unknown to the port")
    return SpecSeeds(*JAX_SPEC_SEEDS[key])


def save_spec_seeds(run_dir: str, seeds: SpecSeeds) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, SEEDS_FILE), "w") as f:
        json.dump({"obj": list(seeds.obj), "bg": list(seeds.bg)}, f)


def make_specs(cfg: Config, seeds: SpecSeeds) -> SupairSpecs:
    obj = spn_lib.make_spec(
        seeds.obj, cfg.patch_size ** 2, cfg.obj_spn_depth,
        cfg.obj_spn_num_sums, cfg.obj_spn_num_leaves,
        cfg.obj_spn_repetitions, min_std=cfg.leaf_min_std,
        max_std=cfg.leaf_max_std)
    bg = spn_lib.make_spec(
        seeds.bg, cfg.img_size ** 2, cfg.bg_spn_depth, cfg.bg_spn_num_sums,
        cfg.bg_spn_num_leaves, cfg.bg_spn_repetitions,
        min_std=cfg.leaf_min_std, max_std=cfg.leaf_max_std)
    return SupairSpecs(obj, bg)


def init_params(cfg: Config, specs: SupairSpecs,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    return {
        "encoder": encoder_lib.init_params(cfg, generator, device),
        "obj_spn": spn_lib.init_params(specs.obj, generator, device),
        "bg_spn": spn_lib.init_params(specs.bg, generator, device),
    }


def encode(params: Dict, cfg: Config, frames: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (B, H, W) → q(z_where) (mean, std), each (B, O, 4)."""
    return encoder_lib.apply(params["encoder"], cfg, frames)


def likelihood(params: Dict, cfg: Config, specs: SupairSpecs,
               frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """log p(x | z_where): frames (B, H, W), boxes (B, O, 4) → (B,)."""
    B, O = boxes.shape[:2]
    P = cfg.patch_size
    if cfg.likelihood_impl == "pallas":
        return fused_likelihood.likelihood_fused(cfg, specs, params, frames,
                                                 boxes)
    patches = glimpse.extract_glimpses(frames, boxes, P)
    if cfg.overlap_correction and O > 1 and cfg.overlap_impl != "patch":
        patch_w, bg_vis = image_weights(cfg, boxes)
    else:
        patch_w, bg_vis = fused_likelihood.patch_weights(cfg, boxes)
    if cfg.spn_impl == "pallas":
        spn_fn = fused_spn.spn_log_prob_fused
    elif cfg.spn_impl == "dense":
        spn_fn = spn_lib.spn_log_prob
    elif cfg.spn_impl == "matmul":
        spn_fn = spn_lib.spn_log_prob_matmul
    else:
        raise ValueError(f"unknown spn_impl={cfg.spn_impl!r}: 'dense', "
                         "'matmul' or 'pallas'")
    obj_ll = spn_fn(specs.obj, params["obj_spn"],
                    patches.reshape(B * O, P * P),
                    patch_w.reshape(B * O, P * P))
    bg_ll = spn_fn(specs.bg, params["bg_spn"], frames.reshape(B, -1),
                   bg_vis.reshape(B, -1))
    return torch.sum(obj_ll.reshape(B, O), dim=1) + bg_ll


def image_weights(cfg: Config, boxes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The image-space claim weights of `overlap_impl="image"`
    (supair.py:206-222): each box's coverage mask on the pixel grid, an
    exclusive running max over the objects (what earlier objects
    claimed), glimpsed at each box like the frame and clipped to [0, 1];
    the background sees 1 − the running max over all objects.  boxes
    (B, O, 4) → (patch weights (B, O, P, P), background weights (B, H, W)).

    The running max is a chain of `torch.maximum`, not `torch.cummax`:
    where two coverages are equal (boxes that coincide), the reference's
    `lax.cummax` splits the gradient between them, as `torch.maximum`
    does, while `torch.cummax` sends all of it to one."""
    B, O = boxes.shape[:2]
    H, P = cfg.img_size, cfg.patch_size
    cover = glimpse.box_coverage(boxes, H)                    # (B, O, H, W)
    cums = [cover[:, 0]]
    for o in range(1, O):
        cums.append(torch.maximum(cums[-1], cover[:, o]))
    cum = torch.stack(cums, 1)
    claimed = torch.cat([torch.zeros_like(cover[:, :1]), cum[:, :-1]], 1)
    w_all = 1.0 - glimpse.extract_glimpses(
        claimed.reshape(B * O, H, H), boxes.reshape(B * O, 1, 4), P)[:, 0]
    return (torch.clamp(w_all, 0.0, 1.0).reshape(B, O, P, P),
            1.0 - cum[:, -1])


def where_prior_logp(cfg: Config, boxes: torch.Tensor) -> torch.Tensor:
    """log p(z_where): Gaussian prior on scales, uniform on [−1, 1]²
    positions (constant −log 2 per coordinate).  boxes (B, O, 4) → (B,)."""
    s_mean = 0.5 * (cfg.scale_min + cfg.scale_max)
    s_std = 0.5 * (cfg.scale_max - cfg.scale_min)
    lp_scale = gaussians.log_prob(boxes[..., 0:2], s_mean, s_std)
    lp_pos = torch.full_like(boxes[..., 2:4], -math.log(2.0))
    return torch.sum(lp_scale, (-2, -1)) + torch.sum(lp_pos, (-2, -1))


def elbo(params: Dict, cfg: Config, specs: SupairSpecs, frames: torch.Tensor,
         noise: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SuPAIR-only ELBO with reparameterized box samples.

    frames (B, H, W); noise (B, O, 4) standard normals (supair.py:266
    draws them from its key).  Returns the mean ELBO and diagnostics.
    """
    mean, std = encode(params, cfg, frames)
    z = gaussians.sample(mean, std, noise)
    ll = likelihood(params, cfg, specs, frames, z)
    lp = where_prior_logp(cfg, z)
    lq = torch.sum(gaussians.log_prob(z, mean, std), (-2, -1))
    diag = {
        "supair_ll": torch.mean(ll),
        "supair_prior": torch.mean(lp),
        "supair_entropy": -torch.mean(lq),
        "boxes_mean_scale": torch.mean(mean[..., 0:2]),
    }
    return torch.mean(ll + lp - lq), diag
