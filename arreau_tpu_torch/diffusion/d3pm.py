"""D3PM discrete (masking) diffusion over atom types: forward corruption,
the hybrid loss and the reverse steps; counterpart of
``arreau_tpu/diffusion/d3pm.py``.

The forward process is the sampler's "mask" process: every real class
jumps to the absorbing MASK class (last index) with probability
``mask_prob`` per step. The transition tables are built on the host in
numpy float64, exactly as the JAX package builds them, then cast to
float32. Random numbers are passed in as uniform draws in [0, 1) and
turned into gumbel noise here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

EPS = 1e-6
MASK_TRANSITION_PROB = 0.02


class D3PMTables(NamedTuple):
    q_one_step_transposed: torch.Tensor  # [T, C, C]
    q_mats: torch.Tensor  # [T, C, C] cumulative products Qbar_t = Q_1 ... Q_t
    hybrid_loss_coeff: float = 0.001


def _one_step_mats(num_steps: int, num_classes: int, mask_prob: float) -> np.ndarray:
    """Host-side one-step transition matrices Q_1..Q_T (fp64)."""
    mat = np.zeros((num_classes, num_classes))
    mat[:, -1] = mask_prob
    np.fill_diagonal(mat, 1 - mask_prob)
    mat[-1, -1] = 1.0
    return np.broadcast_to(mat, (num_steps, num_classes, num_classes)).copy()


def make_d3pm_tables(
    num_steps: int, num_classes: int, mask_prob: float = MASK_TRANSITION_PROB, device="cpu"
) -> D3PMTables:
    one_step = _one_step_mats(num_steps, num_classes, mask_prob)
    q_mats = np.zeros_like(one_step)
    q_mats[0] = one_step[0]
    for idx in range(1, num_steps):
        q_mats[idx] = q_mats[idx - 1] @ one_step[idx]
    return D3PMTables(
        q_one_step_transposed=torch.as_tensor(
            one_step.transpose(0, 2, 1), dtype=torch.float32, device=device
        ),
        q_mats=torch.as_tensor(q_mats, dtype=torch.float32, device=device),
    )


def make_strided_transitions(
    num_steps: int,
    num_classes: int,
    ts: np.ndarray,
    mask_prob: float = MASK_TRANSITION_PROB,
    device="cpu",
) -> torch.Tensor:
    """``[len(ts)-1, C, C]``: entry k is ``(Q_{s+1} ... Q_t)^T`` for
    ``s = ts[k], t = ts[k+1]`` (fp64 on the host, then cast)."""
    ts = np.asarray(ts, dtype=np.int64)
    if ts.ndim != 1 or ts.size < 2 or np.any(np.diff(ts) <= 0):
        raise ValueError("ts must be a strictly increasing timestep sequence")
    if ts[-1] > num_steps - 1 or ts[0] < 0:
        raise ValueError(f"ts out of range [0, {num_steps - 1}]")
    one_step = _one_step_mats(num_steps, num_classes, mask_prob)
    out = np.zeros((ts.size - 1, num_classes, num_classes), dtype=np.float64)
    for k in range(ts.size - 1):
        mat = np.eye(num_classes)
        for i in range(int(ts[k]), int(ts[k + 1])):
            mat = mat @ one_step[i]
        out[k] = mat
    return torch.as_tensor(out.transpose(0, 2, 1), dtype=torch.float32, device=device)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(torch.clamp(u, EPS, 1.0)))


def _posterior_step(tables, fact1, uniform, predicted_x0_logits, s, temperature):
    """Gumbel draw from ``q(x_s | x_t, x0) ~ q(x_t | x_s) q(x_s | x0)``
    given ``fact1 = q(x_t | x_s)`` per class; ``s == 0`` samples the x0
    logits with the gumbel damped 5x."""
    softmaxed = torch.softmax(predicted_x0_logits, dim=-1)
    qbar_s = tables.q_mats[torch.clamp(s - 1, min=0)]  # [B, A, C, C]
    fact2 = torch.einsum("...c,...cd->...d", softmaxed, qbar_s)
    post = torch.log(fact1 + EPS) + torch.log(fact2 + EPS)
    post = torch.where((s == 0)[..., None], predicted_x0_logits, post)
    damp = 0.2 + (s != 0).to(post.dtype) * 0.8
    g = gumbel_from_uniform(uniform)
    return torch.argmax(post + g * (temperature * damp[..., None]), dim=-1)


def d3pm_reverse_step(
    tables: D3PMTables,
    uniform: torch.Tensor,
    xt: torch.Tensor,
    predicted_x0_logits: torch.Tensor,
    t: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Gumbel posterior step ``t -> t-1`` (``xt``, ``t``: ``[B, A]``)."""
    fact1 = tables.q_one_step_transposed[t - 1, xt, :]  # [B, A, C]
    return _posterior_step(tables, fact1, uniform, predicted_x0_logits, t - 1, temperature)


def d3pm_strided_reverse_step(
    tables: D3PMTables,
    q_strided_transposed: torch.Tensor,
    uniform: torch.Tensor,
    xt: torch.Tensor,
    predicted_x0_logits: torch.Tensor,
    s: torch.Tensor,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Strided gumbel posterior step ``t -> s`` with one ``[C, C]``
    transposed strided transition ``Q_{s->t}^T``."""
    fact1 = q_strided_transposed[xt, :]  # [B, A, C]
    return _posterior_step(tables, fact1, uniform, predicted_x0_logits, s, temperature)


def d3pm_sample_xt(tables: D3PMTables, uniform: torch.Tensor, x0: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Forward corruption ``x_t ~ Cat(x0 @ Qbar_t)`` by gumbel-argmax from
    ``uniform [B, A, C]``; ``x0``, ``t``: ``[B, A]``, t in [1, T]."""
    probs = tables.q_mats[t - 1, x0, :]
    return torch.argmax(torch.log(probs + EPS) + gumbel_from_uniform(uniform), dim=-1)


def _q_posterior_logits_from_onehotish(tables: D3PMTables, x0_logits: torch.Tensor,
                                       xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log q(x_{t-1} | x_t, x0-distribution); the x0 logits at ``t == 1``."""
    fact1 = tables.q_one_step_transposed[t - 1, xt, :]
    softmaxed = torch.softmax(x0_logits, dim=-1)
    qmats2 = tables.q_mats[torch.clamp(t - 2, min=0)]  # Qbar_{t-1}; replaced at t == 1
    fact2 = torch.einsum("...c,...cd->...d", softmaxed, qmats2)
    out = torch.log(fact1 + EPS) + torch.log(fact2 + EPS)
    return torch.where((t == 1)[..., None], x0_logits, out)


def q_posterior_logits(tables: D3PMTables, x0: torch.Tensor, xt: torch.Tensor,
                       t: torch.Tensor) -> torch.Tensor:
    """Posterior logits for integer classes or logits ``x0``."""
    if not torch.is_floating_point(x0):
        num_classes = tables.q_mats.shape[-1]
        x0 = torch.log(torch.nn.functional.one_hot(x0.long(), num_classes).to(tables.q_mats.dtype)
                       + EPS)
    return _q_posterior_logits_from_onehotish(tables, x0, xt, t)


def _vb_kl(dist1: torch.Tensor, dist2: torch.Tensor, atom_mask: torch.Tensor,
           denom: torch.Tensor) -> torch.Tensor:
    """Masked sum of KL(softmax(dist1) || softmax(dist2)) over real atoms
    over ``denom``, with the reference's eps added to the logits."""
    kl = torch.softmax(dist1 + EPS, dim=-1) * (
        torch.log_softmax(dist1 + EPS, dim=-1) - torch.log_softmax(dist2 + EPS, dim=-1)
    )
    return torch.where(atom_mask, kl.sum(dim=-1), 0.0).sum() / denom


def d3pm_loss(tables: D3PMTables, x0: torch.Tensor, predicted_x0_logits: torch.Tensor,
              xt: torch.Tensor, t: torch.Tensor, atom_mask: torch.Tensor,
              num_atoms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hybrid loss: ``hybrid_loss_coeff`` x VB-KL + cross-entropy against
    x0, both masked means over real atoms. ``num_atoms``, the real-atom
    count to divide by, defaults to this batch's (at least 1); under data
    parallelism it is the global batch's, and the loss is this rank's part
    of the global mean."""
    if num_atoms is None:
        num_atoms = torch.clamp(atom_mask.sum(), min=1)
    vb = _vb_kl(q_posterior_logits(tables, x0, xt, t),
                q_posterior_logits(tables, predicted_x0_logits, xt, t), atom_mask, num_atoms)
    logp = torch.log_softmax(predicted_x0_logits, dim=-1)
    ce = -torch.gather(logp, -1, x0.long()[..., None])[..., 0]
    ce = torch.where(atom_mask, ce, 0.0).sum() / num_atoms
    return tables.hybrid_loss_coeff * vb + ce
