"""RAT-SPN (random tensorized sum-product network) as dense log-space ops.

Counterpart of `stove_tpu/models/spn.py`.  Each repetition r permutes the
V variables and splits the permutation into 2^D balanced contiguous leaf
regions; region k at depth d has children 2k and 2k+1 at depth d+1, so a
product layer is a reshape.  Leaves are I Gaussians per (repetition,
variable); a leaf region's log-density is the sum of its variables' leaf
log-densities, each multiplied by a per-variable weight w ∈ [0, 1]
(w = 0 marginalises the variable out exactly).  Sum layers are
log-mixtures over the c² products of their two children; a learned root
mixes the R·S top sums.

The region graph is not a parameter: `make_spec` builds it from one seed
per repetition, each feeding `np.random.RandomState(seed).permutation`, as
the reference does.  The reference draws those seeds with `jax.random`
from the run's seed; the port cannot draw threefry bits, so it takes them
from the caller (`models/supair.py`: `run_spec_seeds`, `draw_spec_seeds`).

`spn_log_prob` is the plain version: the oracle of the fused CUDA kernel
(`ops/fused_spn.py`) and the path `spn_impl="dense"` takes;
`spn_log_prob_matmul` computes the same function with the leaf stage as
three matrix products (`spn_impl="matmul"`).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class SpnSpec(NamedTuple):
    """Static structure of one RAT-SPN."""
    num_vars: int
    depth: int            # D recursive splits → 2^D leaf regions per rep
    num_sums: int         # S sum nodes per internal region
    num_leaves: int       # I Gaussian components per (rep, variable)
    num_reps: int         # R repetitions
    perms: np.ndarray     # (R, V) variable permutation per repetition
    scopes: np.ndarray    # (R, 2^D, V) float32 leaf-region scope matrix
    min_std: float
    max_std: float

    @property
    def num_leaf_regions(self) -> int:
        return 2 ** self.depth


def _region_slices(num_vars: int, depth: int):
    """Balanced contiguous chunk boundaries for 2^depth regions."""
    bounds = np.linspace(0, num_vars, 2 ** depth + 1).round().astype(int)
    return [(bounds[k], bounds[k + 1]) for k in range(2 ** depth)]


def make_spec(seeds: Sequence[int], num_vars: int, depth: int,
              num_sums: int, num_leaves: int, num_reps: int,
              min_std: float = 0.05, max_std: float = 1.0) -> SpnSpec:
    """The region graph from one permutation seed per repetition."""
    assert 2 ** depth <= num_vars, "more leaf regions than variables"
    if len(seeds) != num_reps:
        raise ValueError(f"{len(seeds)} seeds for {num_reps} repetitions")
    perms = np.stack([np.random.RandomState(int(s)).permutation(num_vars)
                      for s in seeds])
    L = 2 ** depth
    scopes = np.zeros((num_reps, L, num_vars), dtype=np.float32)
    for r in range(num_reps):
        for k, (a, b) in enumerate(_region_slices(num_vars, depth)):
            scopes[r, k, perms[r, a:b]] = 1.0
    return SpnSpec(num_vars, depth, num_sums, num_leaves, num_reps, perms,
                   scopes, min_std, max_std)


def init_params(spec: SpnSpec, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Gaussian leaves + sum-layer logits + root logits, drawn as the
    reference does: leaf means U(0, 1), raw stds 0.5·N(0, 1), logits
    0.01·N(0, 1)."""
    R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                     spec.num_sums, spec.depth)

    def normal(*shape):
        return torch.randn(shape, generator=generator).to(device)

    params = {"leaf_mu": torch.rand((R, V, I), generator=generator).to(device),
              "leaf_raw_std": 0.5 * normal(R, V, I)}
    c = I
    for d in range(D - 1, -1, -1):
        params[f"sum_logits_{d}"] = 0.01 * normal(R, 2 ** d, S, c * c)
        c = S
    params["root_logits"] = 0.01 * normal(R * S)
    return params


# scope matrices on their devices: (id of the spec's array, dtype, device)
# -> (the array, which keeps its id from being reused, and the tensor)
_SCOPES: Dict[Tuple, Tuple[np.ndarray, torch.Tensor]] = {}


def scope_matrix(spec: SpnSpec, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """`spec.scopes` (R, 2^D, V) as `dtype` on `device`, copied there once
    a (spec, dtype, device), so that an evaluation copies nothing from the
    host."""
    key = (id(spec.scopes), dtype, str(device))
    got = _SCOPES.get(key)
    if got is None:
        got = _SCOPES[key] = (spec.scopes, torch.as_tensor(
            spec.scopes, dtype=dtype, device=device))
    return got[1]


def _leaf_std(spec: SpnSpec, raw: torch.Tensor) -> torch.Tensor:
    return spec.min_std + (spec.max_std - spec.min_std) * torch.sigmoid(raw)


_LOG2PI = math.log(2.0 * math.pi)


def spn_log_prob(spec: SpnSpec, params: Dict[str, torch.Tensor],
                 x: torch.Tensor, weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """log p(x) under the RAT-SPN.  x, weight: (B, V) → (B,)."""
    mu = params["leaf_mu"]                                    # (R, V, I)
    std = _leaf_std(spec, params["leaf_raw_std"])
    z = (x[:, None, :, None] - mu[None]) / std[None]          # (B, R, V, I)
    ll = -0.5 * (z * z + _LOG2PI) - torch.log(std)[None]
    if weight is not None:
        ll = ll * weight[:, None, :, None]
    scope = scope_matrix(spec, ll.dtype, x.device)
    acts = torch.einsum("brvi,rlv->brli", ll, scope)          # (B, R, L, I)
    return _sum_layers(spec, params, acts)


def spn_log_prob_matmul(spec: SpnSpec, params: Dict[str, torch.Tensor],
                        x: torch.Tensor, weight: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """`spn_log_prob` with the leaf stage as three (B, V) @ (V, R·L·I)
    products (`spn_impl="matmul"`, spn.py:150).  Expanding each Gaussian
    leaf's log-density in powers of x,

        w·ll[b,r,v,i] = −½ (w x²)[b,v] a2[r,v,i] + (w x)[b,v] a1[r,v,i]
                        − w[b,v] c0[r,v,i],
        a2 = 1/σ², a1 = μ/σ², c0 = ½μ²/σ² + ½log 2π + log σ,

    folds the scope sum into parameter-only matrices
    M_k[v, (r, l, i)] = scope[r, l, v]·coef_k[r, v, i], so no (B, R, V, I)
    tensor exists.  The same function as `spn_log_prob` up to float32
    summation order (the expansion cancels large terms where |x − μ| ≪ σ
    is not the case; the reference computes the products at bf16x3, here
    in IEEE float32 with TF32 off)."""
    R, I = spec.num_reps, spec.num_leaves
    B, V = x.shape
    L = spec.num_leaf_regions
    if weight is None:
        weight = torch.ones_like(x)
    mu = params["leaf_mu"]                                    # (R, V, I)
    std = _leaf_std(spec, params["leaf_raw_std"])
    a2 = 1.0 / (std * std)
    a1 = mu * a2
    c0 = 0.5 * mu * mu * a2 + 0.5 * _LOG2PI + torch.log(std)
    scope = scope_matrix(spec, x.dtype, x.device)

    def fold(coef):                                           # (V, R·L·I)
        return torch.einsum("rlv,rvi->vrli", scope, coef).reshape(
            V, R * L * I)

    acts = (-0.5 * ((weight * x * x) @ fold(a2))
            + (weight * x) @ fold(a1) - weight @ fold(c0))
    return _sum_layers(spec, params, acts.reshape(B, R, L, I))


def _sum_layers(spec: SpnSpec, params: Dict[str, torch.Tensor],
                acts: torch.Tensor) -> torch.Tensor:
    """The sum and product layers and the root over the leaf regions'
    log-densities acts (B, R, L, I) → (B,)."""
    R, D = spec.num_reps, spec.depth
    for d in range(D - 1, -1, -1):
        left = acts[:, :, 0::2, :, None]
        right = acts[:, :, 1::2, None, :]
        prod = (left + right).reshape(acts.shape[0], R, acts.shape[2] // 2,
                                      -1)                     # (B,R,P,c²)
        logw = torch.log_softmax(params[f"sum_logits_{d}"], dim=-1)
        m = torch.amax(prod, dim=-1, keepdim=True).detach()
        mixed = torch.einsum("brpc,rpsc->brps", torch.exp(prod - m),
                             torch.exp(logw))
        acts = torch.log(torch.clamp(mixed, min=1e-38)) + m   # (B,R,P,S)

    top = acts.reshape(acts.shape[0], -1)                     # (B, R·S)
    root_logw = torch.log_softmax(params["root_logits"], dim=-1)
    return torch.logsumexp(top + root_logw[None], dim=-1)
