#!/bin/bash
# End-to-end rates of this checkout against another commit's, on one card,
# in turns (other, this, this, other): generate's crystals/min at 128 x 8,
# S = 50 (random full-width weights, 1280 crystals), the trained
# flagship's at 100 x 8, S = 100 (500 crystals), and the training CLI's
# steps/s at 256 x 16, hidden 200 (35 steps). Each line is the CLI's own
# throughput line, warm (first batch or step excluded). chip_smoke.py's
# timing lines time one commit; this script alternates two in one call,
# which a comparison needs while the port has no benchmark script, and
# folds into that script once it exists (ROADMAP.md, Queue D4 4).
#
#   git archive <commit> | tar -x -C clean_checkout/old   # drop its out/
#   bash compare_rates.sh clean_checkout/old              # from this checkout's root
set -e
ROOT=$(pwd)
OTHER=$(cd "$1" && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
(cd "$OTHER" && python -c "from arreau_tpu_torch.kernels import build; build.build_library()") &
python -c "from arreau_tpu_torch.kernels import build; build.build_library()"
wait
python - "$WORK/ckpt" <<'PY'
import dataclasses, json, pathlib, sys
from arreau_tpu_torch.data.atoms import synthetic_z_table
from arreau_tpu_torch.interop.from_jax import params_to_jax, save_params_npz
from arreau_tpu_torch.ops import prng
from arreau_tpu_torch.tasks.diffusion import DiffusionConfig, DiffusionModel

z = synthetic_z_table()
cfg = DiffusionConfig(num_atomic_states=len(z))
model = DiffusionModel(cfg, device="cuda")
model.model.init_parameters(prng.prng_key(0))
ckpt = pathlib.Path(sys.argv[1])
(ckpt / "last").mkdir(parents=True)
(ckpt / "meta.json").write_text(json.dumps({
    "config": dataclasses.asdict(cfg), "z_table_zs": [int(v) for v in z.zs],
    "length_stats": {"min": 3.0, "max": 8.0}}))
save_params_npz(str(ckpt / "last" / "params.npz"), params_to_jax(model.model))
PY
for side in other this this other; do
  if [ $side = other ]; then cd "$OTHER"; else cd "$ROOT"; fi
  echo "== $side: generate 1280 crystals, 128 x 8, S = 50"
  python -m arreau_tpu_torch.cli.generate --checkpoint_dir "$WORK/ckpt" --batch_size 128 \
    --num_atoms_per_sample 8 --num_crystals 1280 --sample_steps 50 --seed 0 \
    --out_dir "$WORK/gen" --device cuda | grep throughput
  echo "== $side: the flagship, 500 crystals, 100 x 8, S = 100"
  python -m arreau_tpu_torch.cli.generate --checkpoint_dir "$ROOT/ported_ckpt/ang_on" --tag best \
    --use_ema false --num_crystals 500 --batch_size 100 --num_atoms_per_sample 8 \
    --clip_denoised false --sample_steps 100 --seed 0 --out_dir "$WORK/flagship" \
    --device cuda | grep throughput
  echo "== $side: train 35 steps, 256 x 16, hidden 200"
  rm -rf "$WORK/train"
  python -m arreau_tpu_torch.cli.train_diffusion --dataset synthetic --batch_size 256 \
    --hidden_dim 200 --warmup 0 --max_steps 35 --seed 0 --checkpoint_dir "$WORK/train" \
    --device cuda | grep throughput
done
