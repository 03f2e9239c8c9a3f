"""Joint crystal diffusion: noising, score prediction, the training loss
and the reverse sampler; counterpart of ``arreau_tpu/tasks/diffusion.py``.

The loss noises the three modalities (VE on fractional coordinates, D3PM
on atom types, VP on lattice lengths, and VP on the encoded angles with
``diffuse_angles``), rebuilds the PBC graph, runs the backbone and returns
the weighted sum of the per-modality losses. The sampler runs both chains of
the JAX package: the dense T-1-step reference chain and the strided
DDIM-family chain over ``sample_steps`` levels. Every random number the
loss or the sampler uses is drawn up front into a :class:`LossNoise` or
:class:`SamplerNoise`, or handed in. They are drawn from a JAX key (uint32
``[2]``, ``ops/prng.py:prng_key(seed)``) exactly as the JAX package draws
them: the key is split as the JAX code splits it, the same number of times
in the same order, splits whose keys go unused included, and every field is
``jax.random``'s draw for its key (the threefry kernel on the card,
``kernels/threefry.py``). One seed gives the JAX package's numbers.

Under data parallelism (``parallel/mesh.py``) a rank holds rows ``r::n``
of the global batch: its noise is drawn for the global batch and sliced
(``LossNoise.rows``, ``SamplerNoise.rows``), and the loss divides by the
global batch's real-atom and real-crystal counts (all-reduced), so the
ranks' losses sum to the one-process loss of the global batch and their
gradients are summed (``global_denominators``); the metrics are the
global batch's on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from arreau_tpu_torch.diffusion.d3pm import (
    d3pm_loss,
    d3pm_reverse_step,
    d3pm_sample_xt,
    d3pm_strided_reverse_step,
    make_d3pm_tables,
    make_strided_transitions,
)
from arreau_tpu_torch.diffusion.ve import (
    make_ve_schedule,
    ve_ddim_step,
    ve_forward_pbc,
    ve_reverse_step,
)
from arreau_tpu_torch.diffusion.vp import (
    make_vp_schedule,
    vp_ddim_step_given_x0,
    vp_forward,
    vp_reverse_given_x0,
)
from arreau_tpu_torch.models.blocks import pin_precision
from arreau_tpu_torch.models.ponita import FiberBundleInputs, PonitaConfig, PonitaFiberBundle
from arreau_tpu_torch.kernels import threefry
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.ops.fourier import default_fourier_weights, gaussian_fourier_features
from arreau_tpu_torch.ops.grids import cached_grid_s2, random_so3_matrix
from arreau_tpu_torch.ops.lattice import (
    decode_angles,
    encode_angles,
    frac_to_cart,
    lattice_from_params,
    matrix_to_params,
    sample_bravais_angles,
)
from arreau_tpu_torch.ops.pbc import pbc_neighbor_list
from arreau_tpu_torch.parallel.mesh import data_sum, shard_rows

POS_SIGMA_MIN = 0.001
POS_SIGMA_MAX = 1.0
LATTICE_POWER = 2
LATTICE_CLIPMAX = 0.999
FOURIER_SCALE = 16.0
T_EMB_DIM = 64
ANGLE_CLIP = (0.2, float(np.pi) - 0.2)


class CrystalBatch(NamedTuple):
    """frac_x ``[B, A, 3]``, atom_types ``[B, A]`` z-table indices, lattice
    ``[B, 3, 3]`` row basis, num_atoms ``[B]``, atom_mask ``[B, A]``."""

    frac_x: torch.Tensor
    atom_types: torch.Tensor
    lattice: torch.Tensor
    num_atoms: torch.Tensor
    atom_mask: torch.Tensor


def batch_to_device(batch: CrystalBatch, device, non_blocking: bool = False) -> CrystalBatch:
    """A batch of numpy arrays (the loader's) as tensors on ``device``:
    float32 coordinates and lattices, int64 types and counts, bool mask.
    With ``non_blocking`` (a CUDA device) each is converted on the host,
    pinned and copied asynchronously on the current stream."""
    dtypes = (torch.float32, torch.long, torch.float32, torch.long, torch.bool)
    if not non_blocking:
        return CrystalBatch(*(torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
                              for a, dt in zip(batch, dtypes)))
    return CrystalBatch(*(torch.as_tensor(np.asarray(a)).to(dtype=dt).pin_memory()
                          .to(device=device, non_blocking=True) for a, dt in zip(batch, dtypes)))


def rotate_batch(key, batch: CrystalBatch, mesh=None) -> CrystalBatch:
    """Rotation augmentation, the JAX package's ``rotate_batch(key,
    batch)``: one rotation per crystal of the global batch drawn from the
    JAX key ``key`` (``random_so3_matrix(key, (B,))``), this data rank's
    rows applied to the lattice rows (rows @ R^T); fractional coordinates
    stay."""
    B = batch.lattice.shape[0] * (mesh.data_size if mesh is not None else 1)
    rotations = shard_rows(random_so3_matrix(key, (B,), batch.lattice.dtype,
                                             batch.lattice.device), mesh)
    return batch._replace(lattice=torch.einsum("brj,bij->bri", batch.lattice, rotations))


@dataclass(frozen=True)
class DiffusionConfig:
    """The JAX package's ``DiffusionConfig``, field for field, so a
    checkpoint's ``meta.json`` loads unchanged. ``compute_dtype`` is None
    (float32) or ``"bfloat16"``; the losses and the sampler's states stay
    float32 either way."""

    num_atomic_states: int  # len(z_table) incl. the MASK class
    num_timesteps: int = 1000
    radius: float = 5.0
    max_neighbors: int = 8
    hidden_dim: int = 200
    basis_dim: int = 256
    degree: int = 3
    num_layers: int = 5
    num_ori: int = 16
    widening_factor: int = 4
    layer_scale: Optional[float] = 1e-6
    multiple_readouts: bool = True
    coord_loss_weight: float = 1.0
    atom_type_loss_weight: float = 1.0
    lattice_loss_weight: float = 1.0
    fourier_seed: int = 1234
    mask_prob: float = 0.02
    remat: bool = False
    compute_dtype: Optional[str] = None
    # None = the CUDA kernels on a CUDA device; True/False = force
    use_pallas: Optional[bool] = None
    fuse_fiber: bool = False
    basis_bias: "bool | str" = True
    stacked_readout: bool = True
    diffuse_angles: bool = False
    angle_loss_weight: float = 1.0

    @property
    def in_scalar_dim(self) -> int:
        # [one-hot types | t_emb | num_atoms | lengths | angles | scaled lengths]
        return self.num_atomic_states + T_EMB_DIM + 1 + 3 + 3 + 3

    @property
    def in_vec_dim(self) -> int:
        return 1 + 3  # fractional coords + 3 lattice rows

    def ponita_config(self) -> PonitaConfig:
        return PonitaConfig(
            input_dim_scalar=self.in_scalar_dim,
            input_dim_vec=self.in_vec_dim,
            hidden_dim=self.hidden_dim,
            basis_dim=self.basis_dim,
            degree=self.degree,
            num_layers=self.num_layers,
            widening_factor=self.widening_factor,
            layer_scale=self.layer_scale,
            multiple_readouts=self.multiple_readouts,
            radius=self.radius,
            num_ori=self.num_ori,
            output_dim_scalar=self.num_atomic_states,
            output_dim_vec=1,
            output_dim_global_scalar=3 + (6 if self.diffuse_angles else 0),
            expected_degree=float(self.max_neighbors),
            use_kernels=self.use_pallas,
            fuse_fiber=self.fuse_fiber,
            basis_bias=self.basis_bias,
            compute_dtype=self.compute_dtype,
            remat=self.remat,
            stacked_readout=self.stacked_readout,
        )


def strided_levels(num_timesteps: int, sample_steps: int) -> np.ndarray:
    """Chain levels ``0 = ts[0] < ... < ts[-1] = T-1`` of the strided sampler."""
    total = num_timesteps - 1
    return np.unique(np.round(np.linspace(0, total, sample_steps + 1)).astype(np.int64))


@dataclass
class SamplerNoise:
    """Every random number of one sampler run. Prior: ``angles [B, 3]``
    (radians; None with ``diffuse_angles``), ``ang_enc0 [B, 6]``,
    ``lengths0 [B, 3]``, ``frac0 [B, A, 3]``. Per step s of the chain:
    standard normals ``lattice [S, B, 3]``, ``angle [S, B, 6]``, ``pos [S,
    B, A, 3]`` and uniforms ``types [S, B, A, C]`` for the gumbel draws."""

    angles: Optional[torch.Tensor]
    ang_enc0: torch.Tensor
    lengths0: torch.Tensor
    frac0: torch.Tensor
    lattice: torch.Tensor
    angle: torch.Tensor
    pos: torch.Tensor
    types: torch.Tensor

    def rows(self, mesh) -> "SamplerNoise":
        """The data rank's rows of noise drawn for the global batch (the
        per-step fields are ``[S, B, ...]``)."""
        return SamplerNoise(*(None if x is None else shard_rows(x, mesh, dim)
                              for x, dim in zip((self.angles, self.ang_enc0, self.lengths0,
                                                 self.frac0, self.lattice, self.angle, self.pos,
                                                 self.types), (0, 0, 0, 0, 1, 1, 1, 1))))


def sampler_step_keys(key, num_steps: int) -> np.ndarray:
    """uint32 ``[num_steps, 4, 2]``: the keys ``(k_lat, k_pos, k_type,
    k_ang)`` of each step of the sampler's chain from its loop key, as each
    step of the JAX sampler splits them off (``key, k_lat, k_pos, k_type,
    k_ang = split(key, 5)``)."""
    out = np.empty((num_steps, 4, 2), np.uint32)
    key = np.asarray(key, np.uint32)
    for s in range(num_steps):
        keys = prng.split(key, 5)
        key, out[s] = keys[0], keys[1:]
    return out


def draw_sampler_noise(key, num_steps: int, B: int, A: int, C: int, lattice_type: str,
                       diffuse_angles: bool, device) -> SamplerNoise:
    """The :class:`SamplerNoise` the JAX sampler draws from ``key`` (uint32
    ``[2]``) for ``num_steps`` steps of B crystals of A atoms and C
    classes, on ``device``: ``k_ang, k_len, k_frac, k_loop = split(key,
    4)`` for the prior, then each step's keys off ``k_loop``
    (:func:`sampler_step_keys`); each per-step field of the whole chain is
    one draw for ``S`` keys. Without ``diffuse_angles`` the JAX sampler
    leaves the angle keys unused; the angle field is drawn from them all the
    same (the sampler does not read it; an exported program takes it)."""
    k_ang, k_len, k_frac, k_loop = prng.split(np.asarray(key, np.uint32), 4)
    if diffuse_angles:
        angles, ang_enc0 = None, threefry.normal(k_ang, (B, 6), device)
    else:
        angles = sample_bravais_angles(k_ang, lattice_type, B, device)
        ang_enc0 = torch.zeros((B, 6), device=device)
    steps = sampler_step_keys(k_loop, num_steps)
    return SamplerNoise(
        angles=angles,
        ang_enc0=ang_enc0,
        lengths0=threefry.normal(k_len, (B, 3), device),
        frac0=threefry.normal(k_frac, (B, A, 3), device) * POS_SIGMA_MAX,
        lattice=threefry.normal(steps[:, 0], (B, 3), device),
        angle=threefry.normal(steps[:, 3], (B, 6), device),
        pos=threefry.normal(steps[:, 1], (B, A, 3), device),
        types=threefry.uniform(steps[:, 2], (B, A, C), device),
    )


@dataclass
class LossNoise:
    """Every random number of one loss evaluation: timesteps ``t [B]`` in
    [1, T], standard normals ``pos [B, A, 3]``, ``lattice [B, 3]`` and
    ``angle [B, 6]`` (None without ``diffuse_angles``), and uniforms ``types
    [B, A, C]`` for the gumbel draw of the noisy types."""

    t: torch.Tensor
    pos: torch.Tensor
    types: torch.Tensor
    lattice: torch.Tensor
    angle: Optional[torch.Tensor]

    def rows(self, mesh) -> "LossNoise":
        """The data rank's rows of noise drawn for the global batch."""
        return LossNoise(*(None if x is None else shard_rows(x, mesh)
                           for x in (self.t, self.pos, self.types, self.lattice, self.angle)))


def draw_loss_noise(key, B: int, A: int, C: int, num_timesteps: int, diffuse_angles: bool,
                    device, timestep: Optional[int] = None) -> LossNoise:
    """The :class:`LossNoise` the JAX package's ``DiffusionModel.loss``
    draws from ``key`` (uint32 ``[2]``) for B crystals of A atoms and C
    classes, on ``device``: ``k_t, k_pos, k_type, k_lat, k_ang = split(key,
    5)``, t from ``randint(k_t, (B,), 1, T + 1)`` unless ``timestep`` fixes
    it (``k_t`` then goes unused, as in the JAX loss)."""
    k_t, k_pos, k_type, k_lat, k_ang = prng.split(np.asarray(key, np.uint32), 5)
    if timestep is None:
        t = threefry.randint(k_t, (B,), 1, num_timesteps + 1, device)
    else:
        t = torch.full((B,), timestep, dtype=torch.long, device=device)
    return LossNoise(
        t=t,
        pos=threefry.normal(k_pos, (B, A, 3), device),
        types=threefry.uniform(k_type, (B, A, C), device),
        lattice=threefry.normal(k_lat, (B, 3), device),
        angle=threefry.normal(k_ang, (B, 6), device) if diffuse_angles else None,
    )


def _decode_angles_safe(enc: torch.Tensor) -> torch.Tensor:
    return torch.clamp(decode_angles(enc), ANGLE_CLIP[0], ANGLE_CLIP[1])


class DiffusionModel:
    """The backbone, schedules and fixed constants on one device; ``mesh``
    (``parallel.mesh.shard_state``) places it in a data/model mesh."""

    # the loss divides by counts of the global batch: gradients sum over ranks
    global_denominators = True
    mesh = None

    def __init__(self, config: DiffusionConfig, device="cuda",
                 fourier_w: Optional[np.ndarray] = None, readout_bf16_operands: bool = False,
                 ori_grid: Optional[np.ndarray] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        pin_precision()
        self.config = config
        self.device = device
        # readout_bf16_operands: the backbone's readout as a TPU computes it
        # (models/ponita.py); a property of the checkpoint, not of the JAX config
        self.model = PonitaFiberBundle(replace(
            config.ponita_config(), readout_bf16_operands=readout_bf16_operands)).to(device).eval()
        T = config.num_timesteps
        self.ve = make_ve_schedule(T, POS_SIGMA_MIN, POS_SIGMA_MAX, device=device)
        self.vp = make_vp_schedule(T, power=LATTICE_POWER, clipmax=LATTICE_CLIPMAX, device=device)
        self.d3pm = make_d3pm_tables(T, config.num_atomic_states, config.mask_prob, device=device)
        if fourier_w is None:
            w = default_fourier_weights(config.fourier_seed, T_EMB_DIM // 2, FOURIER_SCALE)
        else:
            w = torch.tensor(np.asarray(fourier_w), dtype=torch.float32)
        self.fourier_w = w.to(device)
        # ori_grid: the S^2 grid a checkpoint carries (convert_jax_checkpoint.py
        # writes the JAX model's), else the drawn one
        if ori_grid is None:
            ori_grid = cached_grid_s2(config.num_ori)
        self.ori_grid = torch.as_tensor(np.asarray(ori_grid, dtype=np.float64),
                                        dtype=torch.float32, device=device)

    # ---------------- init ----------------

    @torch.no_grad()
    def init(self, key, batch: CrystalBatch) -> None:
        """The parameters the JAX package's ``model.init(key, batch)`` draws
        (``key`` a JAX key, uint32 ``[2]``; ``PonitaFiberBundle.
        init_parameters``), checked against one forward on ``batch`` at the
        inputs the JAX package's ``init`` traces (t = 1, lengths 4, right
        angles)."""
        self.model.init_parameters(key)
        B = batch.frac_x.shape[0]
        dev = self.device
        onehot = F.one_hot(batch.atom_types, self.config.num_atomic_states).to(torch.float32)
        self.predict_scores(batch.frac_x, onehot, torch.ones((B,), dtype=torch.long, device=dev),
                            batch.num_atoms, torch.full((B, 3), 4.0, device=dev),
                            torch.full((B, 3), float(np.pi) / 2, device=dev), batch.atom_mask)

    # ---------------- forward ----------------

    def _build_inputs(self, noisy_frac, noisy_types_onehot, t, num_atoms, noisy_lengths,
                      angles, atom_mask) -> FiberBundleInputs:
        cfg = self.config
        noisy_lattice = lattice_from_params(noisy_lengths, angles)
        t_emb = gaussian_fourier_features(self.vp.betas[t][:, None], self.fourier_w)
        B, A, _ = noisy_frac.shape
        n = num_atoms.to(torch.float32)
        scaled_lengths = torch.abs(noisy_lengths / torch.clamp(n, min=1.0)[:, None])
        per_crystal = torch.cat([t_emb, n[:, None], noisy_lengths, angles, scaled_lengths], dim=-1)
        scalar = torch.cat(
            [noisy_types_onehot, per_crystal[:, None, :].expand(B, A, per_crystal.shape[-1])],
            dim=-1,
        )
        vec = torch.cat(
            [noisy_frac[:, :, None, :], noisy_lattice[:, None, :, :].expand(B, A, 3, 3)], dim=2
        )
        cart = frac_to_cart(noisy_frac, noisy_lattice)
        neighbors = pbc_neighbor_list(cart, noisy_lattice, atom_mask, cfg.radius, cfg.max_neighbors)
        return FiberBundleInputs(scalar=scalar, vec=vec, neighbors=neighbors, atom_mask=atom_mask,
                                 lattice=noisy_lattice, ori_grid=self.ori_grid)

    def predict_scores(self, noisy_frac, noisy_types_onehot, t, num_atoms, noisy_lengths,
                       angles, atom_mask):
        """(pred_frac_eps ``[B, A, 3]``, type logits ``[B, A, C]``, global
        head ``[B, 3]`` or ``[B, 9]`` with ``diffuse_angles``)."""
        inputs = self._build_inputs(noisy_frac, noisy_types_onehot, t, num_atoms, noisy_lengths,
                                    angles, atom_mask)
        out = self.model(inputs)
        return out.node_vec[:, :, 0, :], out.node_scalar, out.global_scalar

    # ---------------- loss ----------------

    def loss(self, batch: CrystalBatch, noise, timestep: Optional[int] = None
             ) -> tuple[torch.Tensor, dict]:
        """(total, metrics): wrapped fractional-coordinate MSE + D3PM hybrid
        loss + lattice-length MSE (+ encoded-angle MSE with
        ``diffuse_angles``), weighted by the config. ``noise`` is a
        :class:`LossNoise`, or a JAX key (uint32 ``[2]``) from which the
        global batch's noise is drawn as the JAX loss draws it
        (:func:`draw_loss_noise`, ``timestep`` fixing t) and this data
        rank's rows kept. Per-atom means are over
        real atoms and per-crystal means over real crystals, so padding slots
        and padding crystals weigh nothing; ``num_crystals`` and
        ``num_atoms`` give those counts for exact epoch means. Every metric
        stays a tensor on the device."""
        if not isinstance(noise, LossNoise):
            B_, A_ = batch.atom_types.shape
            data = self.mesh.data_size if self.mesh is not None else 1
            noise = draw_loss_noise(noise, B_ * data, A_, self.config.num_atomic_states,
                                    self.config.num_timesteps, self.config.diffuse_angles,
                                    self.device, timestep=timestep).rows(self.mesh)
        cfg = self.config
        B, A, _ = batch.frac_x.shape
        t = noise.t
        t_atom = t[:, None].expand(B, A)
        noisy_frac, target_eps, _ = ve_forward_pbc(self.ve, noise.pos, batch.frac_x, t,
                                                   batch.lattice)
        noisy_types = d3pm_sample_xt(self.d3pm, noise.types, batch.atom_types, t_atom)
        lengths, angles = matrix_to_params(batch.lattice)
        noisy_lengths, _ = vp_forward(self.vp, noise.lattice, lengths, t)
        if cfg.diffuse_angles:
            target_enc = encode_angles(angles)
            noisy_enc, _ = vp_forward(self.vp, noise.angle, target_enc, t)
            angles_in = _decode_angles_safe(noisy_enc)
        else:
            angles_in = angles
        onehot = F.one_hot(noisy_types, cfg.num_atomic_states).to(torch.float32)
        pred_eps, logits, pred_global = self.predict_scores(
            noisy_frac, onehot, t, batch.num_atoms, noisy_lengths, angles_in, batch.atom_mask)

        diff = torch.abs(pred_eps - target_eps) % 1.0
        wrapped = torch.minimum(diff, 1.0 - diff)
        # the global batch's counts under data parallelism
        n_valid = torch.clamp(data_sum(batch.atom_mask.sum(), self.mesh), min=1)
        error_coord = torch.where(batch.atom_mask, torch.sum(wrapped**2, dim=-1), 0.0).sum() / n_valid

        error_type = d3pm_loss(self.d3pm, batch.atom_types, logits, noisy_types, t_atom,
                               batch.atom_mask, n_valid)

        example_mask = batch.atom_mask.any(dim=-1)
        n_examples = torch.clamp(data_sum(example_mask.sum(), self.mesh), min=1)
        target_lengths = lengths / torch.clamp(batch.num_atoms, min=1).to(lengths.dtype)[:, None]
        sq = torch.mean((pred_global[:, :3] - target_lengths) ** 2, dim=-1)
        error_lattice = torch.where(example_mask, sq, 0.0).sum() / n_examples

        total = (cfg.coord_loss_weight * error_coord + cfg.atom_type_loss_weight * error_type
                 + cfg.lattice_loss_weight * error_lattice)
        metrics = {"loss_coord": error_coord, "loss_type": error_type,
                   "loss_lattice": error_lattice}
        if cfg.diffuse_angles:
            sq_ang = torch.mean((pred_global[:, 3:9] - target_enc) ** 2, dim=-1)
            metrics["loss_angle"] = torch.where(example_mask, sq_ang, 0.0).sum() / n_examples
            total = total + cfg.angle_loss_weight * metrics["loss_angle"]
        metrics["loss"] = total
        if self.mesh is not None and self.mesh.data_size > 1:
            # the parts of the global means, summed: the global batch's metrics
            keys = list(metrics)
            metrics = dict(zip(keys, data_sum(torch.stack([metrics[k].detach() for k in keys]),
                                              self.mesh)))
        metrics["num_crystals"] = n_examples.to(torch.float32)
        metrics["num_atoms"] = n_valid.to(torch.float32)
        return total, metrics

    # ---------------- sampler ----------------

    def draw_noise(self, key, num_samples: int, num_atoms_per_sample: int,
                   sample_steps: Optional[int] = None,
                   lattice_type: str = "monoclinic") -> SamplerNoise:
        """The :class:`SamplerNoise` :meth:`sample` draws from the JAX key
        ``key`` for these arguments (the dense chain's T-1 steps, or the
        strided chain's), as the JAX package's ``sample(params, key, ...)``
        draws it."""
        total = self.config.num_timesteps - 1
        if sample_steps is not None and sample_steps < total:
            num_steps = strided_levels(self.config.num_timesteps, sample_steps).size - 1
        else:
            num_steps = total
        return draw_sampler_noise(key, num_steps, num_samples, num_atoms_per_sample,
                                  self.config.num_atomic_states, lattice_type,
                                  self.config.diffuse_angles, self.device)

    def sample(self, num_samples: int, num_atoms_per_sample: int, key=None, **kwargs):
        """Generate ``num_samples`` crystals from the JAX key ``key``;
        keyword arguments as :meth:`_sample_impl` (with ``snapshot_every``,
        ``(batch, snapshots)``)."""
        with torch.inference_mode():
            return self._sample_impl(num_samples, num_atoms_per_sample, key=key, **kwargs)

    def _sample_impl(
        self,
        num_samples: int,
        num_atoms_per_sample: int,
        constant_atoms: Optional[torch.Tensor] = None,
        lattice_type: str = "monoclinic",
        length_bounds: Optional[tuple[float, float]] = None,
        type_temperature: float = 1.0,
        sample_steps: Optional[int] = None,
        ddim_eta: float = 0.0,
        num_atoms: Optional[torch.Tensor] = None,
        key=None,
        noise: Optional[SamplerNoise] = None,
        snapshot_every: Optional[int] = None,
    ):
        """Full reverse diffusion. ``sample_steps`` below ``T-1`` runs the
        strided chain over :func:`strided_levels`, else the dense chain.
        ``noise`` injects every random number; without it they are drawn
        from the JAX key ``key`` (:meth:`draw_noise`).

        With ``snapshot_every`` (the dense chain only, as the JAX package's)
        returns ``(batch, [(timestep, batch), ...])``: the state after every
        ``snapshot_every`` steps and at the chain's end, labelled ``T - 1 -
        steps done`` (T = 1000, every 10: 989, 979, ..., 9, 0), each decoded
        as the final batch is. The chain's arithmetic is the same, so the
        final batch equals the one without snapshots bit for bit."""
        cfg = self.config
        dev = self.device
        B, A, C = num_samples, num_atoms_per_sample, cfg.num_atomic_states
        total = cfg.num_timesteps - 1
        if sample_steps is not None and sample_steps < 1:
            raise ValueError(f"sample_steps must be >= 1, got {sample_steps}")
        strided = sample_steps is not None and sample_steps < total
        if strided and snapshot_every is not None:
            raise ValueError("snapshots are not supported with strided sampling")
        ts = strided_levels(cfg.num_timesteps, sample_steps) if strided else None
        num_steps = ts.size - 1 if strided else total
        if noise is None:
            if key is None:
                raise ValueError("sample needs a key (prng.prng_key(seed)) or the noise")
            noise = self.draw_noise(key, B, A, sample_steps, lattice_type)

        angles = noise.angles
        frac, lengths, ang_enc = noise.frac0, noise.lengths0, noise.ang_enc0
        if constant_atoms is not None:
            constant_atoms = torch.as_tensor(constant_atoms, device=dev, dtype=torch.long)
        types = (constant_atoms if constant_atoms is not None
                 else torch.full((B, A), C - 1, dtype=torch.long, device=dev))
        if num_atoms is None:
            num_atoms = torch.full((B,), A, dtype=torch.long, device=dev)
            atom_mask = torch.ones((B, A), dtype=torch.bool, device=dev)
        else:
            num_atoms = torch.as_tensor(num_atoms, device=dev, dtype=torch.long)
            atom_mask = torch.arange(A, device=dev)[None, :] < num_atoms[:, None]

        def predict(frac, types, lengths, ang_enc, t):
            ang = _decode_angles_safe(ang_enc) if cfg.diffuse_angles else angles
            onehot = F.one_hot(types, C).to(torch.float32)
            pred_eps, logits, pred_global = self.predict_scores(
                frac, onehot, t, num_atoms, lengths, ang, atom_mask
            )
            pred_lengths = pred_global[:, :3] * num_atoms.to(torch.float32)[:, None]
            if length_bounds is not None:
                pred_lengths = torch.clamp(pred_lengths, length_bounds[0], length_bounds[1])
            pred_enc = torch.clamp(pred_global[:, 3:9], -1.0, 1.0) if cfg.diffuse_angles else None
            return pred_eps, logits, pred_lengths, pred_enc

        def batch_of(frac, types, lengths, ang_enc):
            ang = _decode_angles_safe(ang_enc) if cfg.diffuse_angles else angles
            return CrystalBatch(frac_x=frac, atom_types=types,
                                lattice=lattice_from_params(lengths, ang), num_atoms=num_atoms,
                                atom_mask=atom_mask)

        snapshots = []
        if strided:
            q_strided_T = make_strided_transitions(cfg.num_timesteps, C, ts, cfg.mask_prob, device=dev)
        for k in range(num_steps):
            if strided:
                idx = num_steps - 1 - k  # pairs walked from high noise to clean
                t = torch.full((B,), int(ts[idx + 1]), dtype=torch.long, device=dev)
                s = torch.full((B,), int(ts[idx]), dtype=torch.long, device=dev)
            else:
                t = torch.full((B,), total - k, dtype=torch.long, device=dev)
            pred_eps, logits, pred_lengths, pred_enc = predict(frac, types, lengths, ang_enc, t)
            if strided:
                lengths = vp_ddim_step_given_x0(self.vp, noise.lattice[k], lengths, pred_lengths,
                                                t, s, ddim_eta)
                if cfg.diffuse_angles:
                    ang_enc = vp_ddim_step_given_x0(self.vp, noise.angle[k], ang_enc, pred_enc,
                                                    t, s, ddim_eta)
                frac = ve_ddim_step(self.ve, noise.pos[k], frac, pred_eps, t, s, ddim_eta)
                types = d3pm_strided_reverse_step(
                    self.d3pm, q_strided_T[idx], noise.types[k], types, logits,
                    s[:, None].expand(B, A), temperature=type_temperature,
                )
            else:
                lengths = vp_reverse_given_x0(self.vp, noise.lattice[k], lengths, pred_lengths, t)
                if cfg.diffuse_angles:
                    ang_enc = vp_reverse_given_x0(self.vp, noise.angle[k], ang_enc, pred_enc, t)
                frac = ve_reverse_step(self.ve, noise.pos[k], frac, pred_eps, t)
                types = d3pm_reverse_step(self.d3pm, noise.types[k], types, logits,
                                          t[:, None].expand(B, A), temperature=type_temperature)
            if constant_atoms is not None:
                types = constant_atoms
            done = k + 1
            if snapshot_every is not None and (done % snapshot_every == 0 or done == num_steps):
                snapshots.append((cfg.num_timesteps - 1 - done, batch_of(frac, types, lengths,
                                                                         ang_enc)))

        batch = batch_of(frac, types, lengths, ang_enc)
        return batch if snapshot_every is None else (batch, snapshots)
