"""The port's data and tensor parallelism (``arreau_tpu_torch/parallel``) on
the CPU, with gloo ranks started as torchrun starts them
(``tests/torch_parallel_worker.py``): the tensor-parallel plan against the
JAX package's ``param_partition_spec``, the loader's multi-host split
against the JAX loader, a 2-rank data-parallel diffusion step against
``jax.value_and_grad`` of the JAX loss on the whole batch and against the
port's one-process step, a data 2 x model 2 step against the one-process
step, the data-parallel sampler, a checkpoint written under data 2 x model
2 and read by one process, and a 2-rank N-body step.

The ranks of two launches (2 and 4 processes) run every scenario once, in
a module fixture; each test reads its results."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arreau_tpu.data.crystal import BucketedLoader as JLoader
from arreau_tpu.data.crystal import pack_dense_batch as j_pack
from arreau_tpu.data.synthetic import synthetic_packed as j_synthetic_packed
from arreau_tpu.parallel.mesh import param_partition_spec
from arreau_tpu.tasks.diffusion import CrystalBatch as JBatch
from arreau_tpu.tasks.diffusion import DiffusionModel as JModel
from arreau_tpu_torch.cli import generate, train_diffusion
from arreau_tpu_torch.data.crystal import BucketedLoader, pack_dense_batch
from arreau_tpu_torch.data.synthetic import synthetic_packed
from arreau_tpu_torch.inference.io import load_sample_results
from arreau_tpu_torch.interop.from_jax import _jax_name, load_params_npz
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    maybe_initialize_distributed,
    param_partition_dim,
)
from arreau_tpu_torch.tasks.diffusion import DiffusionModel, batch_to_device
from arreau_tpu_torch.tasks.nbody import NBodyConfig, NBodyModel
from tests.test_torch_model import port_config, tiny_config
from tests.test_torch_nbody import GRAD_FLOOR
from tests.test_torch_train import (
    GRAD_REL_TOL,
    LOSS_TOL,
    TINY_ARGS,
    _flat,
    _jax_setup,
    _port_model,
    loss_noise,
)
from tests.torch_parallel_worker import diffusion_step

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
# the DP and DP x TP steps against the one-process step: the loss (rtol)
# and each parameter, gradient and EMA shadow against its largest entry;
# float32 sums over other shard and tile sizes (measured ~1e-7)
STEP_RTOL = 1e-5
# the sampler over ranks against one process (types exactly): the float32
# chain of 4 strided steps amplifies the products' roundoff over other row
# counts; one process alone, on the one-process checkpoint below, differs
# by 2.0e-5 in a coordinate between a batch of 4 and its rows 0, 2 sampled
# as a batch of 2 from the same noise
SAMPLER_ATOL = 1e-4
# buckets whose batch sizes at --batch_size 8 (node budget 128: 16, 8, 4)
# are even: one process and 2 data ranks train on the same batches
CLI_ARGS = [*TINY_ARGS, "--buckets", "8,16,32", "--max_steps", "2", "--seed", "1"]
GEN_ARGS = ["--device", "cpu", "--tag", "best", "--num_crystals", "6", "--batch_size", "4",
            "--num_atoms_per_sample", "4", "--sample_steps", "4", "--seed", "3"]
# the backbone tasks' CLIs at a tiny size (the verify recipe's)
TINY_TASK = ["--device", "cpu", "--epochs", "1", "--val_interval", "1", "--hidden_dim", "16",
             "--basis_dim", "8", "--layers", "2"]
TASK_CLIS = {
    "train_nbody": [*TINY_TASK, "--batch_size", "10", "--max_training_samples", "30",
                    "--generate_train", "30", "--num_ori", "4"],
    "train_mnist": [*TINY_TASK, "--batch_size", "4", "--synthetic_size", "50", "--num_ori", "6"],
    "train_qm9": [*TINY_TASK, "--batch_size", "8", "--synthetic_size", "100", "--degree", "2"],
    "train_md17": [*TINY_TASK, "--batch_size", "8", "--synthetic_size", "100", "--degree", "2",
                   "--train_size", "32", "--val_size", "8", "--repeats", "2"],
}
NBODY = dict(hidden_dim=16, basis_dim=12, degree=3, num_layers=2, num_ori=8, use_pallas=True)
LAUNCH_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(scenarios: str, world: int, out: Path) -> None:
    """``world`` ranks of the worker, as torchrun starts them (gloo, CPU)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        log = open(out / f"{scenarios.replace(',', '_')}_rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(WORKER), scenarios, str(out)],
                                       cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=LAUNCH_TIMEOUT)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        text = (out / f"{scenarios.replace(',', '_')}_rank{rank}.log").read_text()
        assert proc.returncode == 0, f"rank {rank} of {scenarios}:\n{text[-4000:]}"


def diffusion_inputs():
    """The JAX setup of tests/test_torch_train.py (6 crystals of up to 4
    atoms, the last a padding example, perturbed parameters,
    ``diffuse_angles``) as the worker's inputs, with the noise the JAX loss
    draws from its key for the whole batch."""
    jmodel, host, params = _jax_setup(True)
    key = jax.random.PRNGKey(7)
    model = _port_model(jmodel, params, use_kernels=True)
    noise = loss_noise(key, host, jmodel.config)
    config = {k: v for k, v in model.config.__dict__.items()}
    inputs = {"config": config, "fourier_w": np.asarray(jmodel.fourier_w),
              "params": {k: v.clone() for k, v in model.model.state_dict().items()},
              "batch": tuple(batch_to_device(host, "cpu")), "noise": noise.__dict__}
    return jmodel, host, params, key, inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    jmodel, host, params, key, inputs = diffusion_inputs()
    torch.save(inputs, out / "dp_inputs.pt")

    nb_model = NBodyModel(NBodyConfig(**NBODY), device="cpu")
    nb_model.init(prng.prng_key(0))
    g = torch.Generator().manual_seed(1)
    nb_batch = tuple(torch.randn(s, generator=g) for s in ((8, 5, 3), (8, 5, 3), (8, 5),
                                                            (8, 5, 3)))
    torch.save({"config": NBODY, "params": nb_model.model.state_dict(), "batch": nb_batch},
               out / "nbody_inputs.pt")

    # a one-process checkpoint (the sampler's, and the topology comparison's)
    ck1 = out / "ck1"
    train_diffusion.main([*CLI_ARGS, "--checkpoint_dir", str(ck1)])
    (out / "generate_args.json").write_text(json.dumps(
        [*GEN_ARGS, "--checkpoint_dir", str(ck1), "--out_dir", str(out / "gen_dp")]))
    ck4 = out / "ck4"
    (out / "train_cli_args.json").write_text(json.dumps(
        [*CLI_ARGS, "--model_parallel", "2", "--checkpoint_dir", str(ck4)]))

    (out / "task_cli_args.json").write_text(json.dumps(
        {name: [*args, "--checkpoint_dir", str(out / f"ck_{name}")]
         + (["--data_dir", str(out / "nbody_data")] if name == "train_nbody" else [])
         for name, args in TASK_CLIS.items()}))

    launch("tp,train_cli", 4, out)
    launch("dp,nbody,generate,task_clis", 2, out)
    return {"out": out, "jmodel": jmodel, "host": host, "params": params, "key": key,
            "inputs": inputs, "nbody": (nb_model, nb_batch), "ck1": ck1, "ck4": ck4}


def _close(got: dict, want: dict, what: str, floor: float = 0.0) -> None:
    """Each tensor within STEP_RTOL of its largest entry (or ``floor``)."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= max(STEP_RTOL * w.abs().max().item(), floor), (what, name, err)


def _close_steps(got: dict, want: dict, before: dict, got_grads: dict, grads: dict) -> None:
    """Parameters after one AdamW step, each within STEP_RTOL of its
    leaf's largest entry or within as much of its own step as its gradient
    moved: AdamW scales every entry's step to ~lr whatever its gradient's
    size, so an entry whose gradient is small against its leaf's carries
    that gradient's relative roundoff into a full step (a first step,
    lr * g / (|g| + eps), changes by at most the gradient's relative
    change)."""
    for name, w in want.items():
        g = grads[name]
        rel = (got_grads[name] - g).abs() / g.abs().clamp_min(torch.finfo(g.dtype).tiny)
        tol = torch.maximum(torch.full_like(w, STEP_RTOL * w.abs().max().item()),
                            (w - before[name]).abs() * rel)
        err = (got[name] - w).abs()
        assert (err <= tol).all(), ("params", name, err.max().item())


# ---------------- the plan and the loader, against JAX ----------------


@pytest.mark.parametrize("basis_bias", [True, "in", False])
def test_tp_plan_matches_jax_param_partition_spec(basis_bias):
    """Every parameter of the JAX tree: ``param_partition_spec`` splits it
    over ``model`` on axis a exactly where the port's plan splits the
    corresponding torch parameter (through the transpose of the Dense
    kernels), and leaves the same ones replicated."""
    jmodel = JModel(tiny_config(diffuse_angles=True, basis_bias=basis_bias))
    host = j_pack(j_synthetic_packed(8, seed=0, max_atoms=4), np.arange(4), 4)
    tree = jmodel.init(jax.random.PRNGKey(0), JBatch(*map(jnp.asarray, host)))
    model = DiffusionModel(port_config(jmodel.config), device="cpu")
    port = {}
    for name, p in model.model.named_parameters():
        key_, transpose = _jax_name(name)
        dim = param_partition_dim(name, p.dim())
        port[key_] = None if dim is None else (1 - dim if transpose else dim)
    want, split = {}, 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(param_partition_spec(path, leaf))
        axis = spec.index("model") if "model" in spec else None
        want["/".join(str(p.key) for p in path)] = axis
        split += axis is not None
    assert port == want
    # 2 basis MLPs and 2 layers: dense_in/linear_1 kernels (and their biases)
    # by columns, dense_out/linear_2 kernels by rows
    assert split == 4 + 4 + (2 if basis_bias is not False else 0) + 2


@pytest.mark.parametrize("num_hosts", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_loader_host_split_matches_jax(seed, num_hosts):
    """Each host's batches, two epochs, equal the JAX loader's bit for bit,
    padding sentinels included; the hosts' batches are disjoint and their
    union is the global chunk."""
    ds, jds = synthetic_packed(150, seed=seed), j_synthetic_packed(150, seed=seed)
    idx = np.arange(120)
    kw = dict(node_budget=10 * 16, seed=seed + 4, batch_multiple=2)
    chunks = BucketedLoader(ds, idx, **kw, num_hosts=num_hosts).chunks()
    padded = 0
    for host in range(num_hosts):
        port = BucketedLoader(ds, idx, **kw, host_index=host, num_hosts=num_hosts)
        ref = JLoader(jds, idx, **kw, host_index=host, num_hosts=num_hosts)
        assert port.batch_multiple == ref.batch_multiple == max(2, num_hosts)
        assert port.num_batches() == ref.num_batches()
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                padded += int((g.num_atoms == 0).sum())
    for bucket, chunk in chunks:
        assert len(chunk) % num_hosts == 0
    assert padded > 0  # a padding sentinel reached some host


# ---------------- one process ----------------


def test_one_process_mesh_is_the_plain_path(monkeypatch):
    """Without a launcher nothing is initialised: rank 0 of 1, the
    one-process mesh, and a step with it equals the step without it bit for
    bit; ``--model_parallel 2`` cannot divide one rank."""
    monkeypatch.delenv("RANK", raising=False)
    assert maybe_initialize_distributed("cpu") == (0, 1)
    assert make_mesh() == Mesh() and Mesh().is_main and not Mesh().distributed
    with pytest.raises(ValueError, match="1 devices not divisible by model_size=2"):
        make_mesh(model_size=2)
    *_, inputs = diffusion_inputs()
    config = {**inputs["config"], "use_pallas": True}
    a, b = diffusion_step(inputs, Mesh(), config), diffusion_step(inputs, None, config)
    assert a["metrics"] == b["metrics"]
    for key_ in ("grads", "params", "ema"):
        for name in a[key_]:
            assert torch.equal(a[key_][name], b[key_][name]), (key_, name)


# ---------------- multi-rank runs ----------------


@pytest.mark.parametrize("branch", ["kernel", "plain"])
def test_dp_step_matches_jax_whole_batch_and_one_process(runs, branch):
    """Two data ranks, each with 3 of the 6 crystals (rows 0, 2, 4 and 1, 3,
    5: different real-atom counts, the padding crystal on rank 1) and its
    rows of the whole batch's noise: the loss terms and every reduced
    gradient equal JAX's value_and_grad on the whole batch (Pallas branch,
    interpret mode) under LOSS_TOL / GRAD_REL_TOL, and the step equals the
    port's one-process step within STEP_RTOL of each tensor's scale. An
    average of per-rank means would fail both."""
    out = runs["out"]
    ranks = [torch.load(out / f"dp_{branch}_rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["real_atoms"] != ranks[1]["real_atoms"]
    host = runs["host"]
    assert (host.num_atoms == 0).sum() == 1 and host.num_atoms[1::2].min() == 0
    jbatch = JBatch(*map(jnp.asarray, host))
    jmodel, key = runs["jmodel"], runs["key"]
    (_, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, key, jbatch), has_aux=True))(runs["params"])
    want_grads = _flat(want_grads)
    for r in ranks:
        for name, value in want_metrics.items():
            np.testing.assert_allclose(r["metrics"][name], float(value), **LOSS_TOL, err_msg=name)
        for name, g in r["grads"].items():
            key_, transpose = _jax_name(name)
            want = want_grads[key_]
            got = (g.t() if transpose else g).numpy()
            assert np.abs(got - want).max() <= GRAD_REL_TOL * np.abs(want).max(), name
    config = {**runs["inputs"]["config"], "use_pallas": branch == "kernel"}
    one = diffusion_step(runs["inputs"], Mesh(), config)
    for r in ranks:
        for name, value in one["metrics"].items():
            if name != "grad_norm":
                np.testing.assert_allclose(r["metrics"][name], value, rtol=STEP_RTOL, err_msg=name)
        for what in ("grads", "params", "ema"):
            _close(r[what], one[what], what)


@pytest.mark.parametrize("case", ["kernel", "plain", "fuse_convnext", "remat"])
def test_dp_tp_step_matches_one_process(runs, case):
    """Data 2 x model 2 (ranks 0-3 at (0,0), (0,1), (1,0), (1,1)): every
    split weight holds half of its split dimension on each rank; the loss
    (rtol STEP_RTOL), every gradient, parameter and EMA shadow after the
    step (within STEP_RTOL of its scale, gathered whole) equal the
    one-process step's. ``fuse_convnext`` runs #9/#10's plain versions on
    gathered weights (compute type float32); ``remat`` runs each block's
    forward, its collectives included, again in the backward."""
    out = runs["out"]
    ranks = [torch.load(out / f"tp_{case}_rank{r}.pt", weights_only=False) for r in range(4)]
    config, fuse = {**runs["inputs"]["config"], "use_pallas": case != "plain"}, False
    if case == "fuse_convnext":
        config, fuse = {**config, "compute_dtype": "float32"}, True
    if case == "remat":
        config = {**config, "remat": True}
    one = diffusion_step(runs["inputs"], Mesh(), config, fuse)
    for rank, r in enumerate(ranks):
        assert r["mesh"] == [2, 2, rank // 2, rank % 2]
        for name, shape in r["local_shapes"].items():
            whole = tuple(one["params"][name].shape)
            dim = param_partition_dim(name, len(whole))
            assert shape[dim] * 2 == whole[dim], name
        assert {"basis_fn.dense_in.weight", "layers.0.linear_2.weight"} <= r["local_shapes"].keys()
        np.testing.assert_allclose(r["metrics"]["loss"], one["metrics"]["loss"], rtol=STEP_RTOL)
        for what in ("grads", "params", "ema"):
            _close(r[what], one[what], what)


def test_dp_sampler_matches_one_process(runs, capsys):
    """``generate --data_parallel true`` over 2 ranks (batches of 4, rows
    0, 2 and 1, 3 on the ranks, the noise drawn whole) writes the crystals
    one process samples: atom types equal, coordinates and lattices within
    SAMPLER_ATOL."""
    out = runs["out"]
    logs = [(out / f"dp_nbody_generate_task_clis_rank{r}.log").read_text() for r in range(2)]
    assert "data-parallel sampling over 2 devices" in logs[0] and "data-parallel" not in logs[1]
    want = generate.main([*GEN_ARGS, "--checkpoint_dir", str(runs["ck1"]), "--out_dir",
                          str(out / "gen_one")])
    got = vars(load_sample_results(str(out / "gen_dp" / "crystals.h5")))
    ref = vars(load_sample_results(str(out / "gen_one" / "crystals.h5")))
    assert got.keys() == ref.keys() and want.num_crystals == 6
    for name in got:
        if got[name].dtype.kind == "f":
            np.testing.assert_allclose(got[name], ref[name], atol=SAMPLER_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_checkpoint_across_topologies(runs):
    """``train_diffusion --model_parallel 2`` on 4 ranks (data 2 x model 2),
    2 steps: its checkpoint has the one-card shapes, only rank 0 wrote
    under the checkpoint directory (meta.json, scores.json, the tags), and
    one process's generate samples from it the crystals it samples from the
    one-process run's checkpoint after the same 2 steps (SAMPLER_ATOL)."""
    out, ck1, ck4 = runs["out"], runs["ck1"], runs["ck4"]
    logs = [json.loads((out / f"train_cli_rank{r}.json").read_text()) for r in range(4)]
    assert {"meta.json", "scores.json", "best", "last"} <= set(logs[0]["writes"])
    assert all(log["writes"] == [] for log in logs[1:])
    assert len({log["loss"] for log in logs}) == 1
    for tag in ("last", "best"):
        for name in ("params.npz", "ema_params.npz"):
            a, b = (_flat(load_params_npz(str(ck / tag / name))) for ck in (ck1, ck4))
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].shape == b[k].shape, k
                assert np.abs(a[k] - b[k]).max() <= STEP_RTOL * np.abs(a[k]).max() + 1e-7, k
    for ck in (ck1, ck4):
        assert json.loads((ck / "scores.json").read_text())["ranked"][0][1] == "best-2"
    results = [generate.main([*GEN_ARGS, "--checkpoint_dir", str(ck), "--out_dir",
                              str(out / f"gen_{ck.name}")]) for ck in (ck1, ck4)]
    np.testing.assert_array_equal(results[0].atomic_numbers, results[1].atomic_numbers)
    for name in ("frac_x", "lattice"):
        np.testing.assert_allclose(getattr(results[1], name), getattr(results[0], name),
                                   atol=SAMPLER_ATOL, err_msg=name)


def test_nbody_dp_step_matches_one_process(runs):
    """The N-body task's loss is a mean over equal shards, so the ranks
    average their gradients: 2 ranks of 4 systems each (#3/#4/#7/#8's plain
    versions) against one process on the 8, from the port's init of
    ``PRNGKey(0)``: the loss within STEP_RTOL, every gradient within
    STEP_RTOL of its scale or GRAD_FLOOR, and every parameter after the
    step as ``_close_steps`` holds it."""
    from arreau_tpu_torch.tasks.nbody import NBodyBatch
    from arreau_tpu_torch.train.loop import train_step
    from arreau_tpu_torch.train.optim import AdamW
    from tests.torch_parallel_worker import LR

    out = runs["out"]
    model, batch = runs["nbody"]
    before = torch.load(out / "nbody_inputs.pt", weights_only=False)["params"]
    optimizer = AdamW(model.model, lambda count: LR, grad_clip=0.5)
    metrics = train_step(model, optimizer, None, NBodyBatch(*batch))
    params = {n: p.detach() for n, p in model.model.named_parameters()}
    grads = {n: p.grad for n, p in model.model.named_parameters()}
    for r in range(2):
        got = torch.load(out / f"nbody_rank{r}.pt", weights_only=False)
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"].item(), rtol=STEP_RTOL)
        # a bias every orientation shares reaches the vector head through the
        # grid's mean direction (~0): its gradient keeps the roundoff of terms
        # ~1e4 larger (tests/test_torch_nbody.py's GRAD_FLOOR). Measured on the
        # init of PRNGKey(0): layers.1.linear_2.bias[0]'s gradient is
        # -1.98344e-07 in one process and -1.98324e-07 on the ranks, 1.05e-04
        # of itself but 1.3e-06 of its leaf's largest (1.59e-05), so its step,
        # 7.99670e-04 against 7.99653e-04 (AdamW's ~lr), moves by 1.69e-08:
        # over STEP_RTOL of the leaf (9.97e-09), within _close_steps' 8.4e-08
        floor = GRAD_FLOOR * max(g.abs().max().item() for g in grads.values())
        _close(got["grads"], grads, "grads", floor)
        _close_steps(got["params"], params, before, got["grads"], grads)


def test_task_clis_train_data_parallel(runs):
    """The N-body, MNIST, QM9 and MD17 training CLIs on 2 ranks: each runs
    to its end on both ranks with the same finite test metric, rank 0
    alone prints."""
    out = runs["out"]
    ranks = [json.loads((out / f"task_clis_rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0].keys() == TASK_CLIS.keys()
    for name in TASK_CLIS:
        assert np.isfinite(ranks[0][name]) and ranks[0][name] == ranks[1][name], name
        assert (out / f"ck_{name}" / "last" / "params.npz").exists()
    logs = [(out / f"dp_nbody_generate_task_clis_rank{r}.log").read_text() for r in range(2)]
    assert "test MSE" in logs[0] and "test MSE" not in logs[1]
