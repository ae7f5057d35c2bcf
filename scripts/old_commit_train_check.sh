#!/bin/bash
# train_large in three packages on one small 2-scene dataset, on the CPU: the
# JAX package of an older commit (by default d7ef376, which wrote
# results/large_scale/train_20k.json), the JAX package of this checkout, and
# the port; each with and without --zero-init-output. Prints every run's
# per-epoch losses and the port's largest relative difference from the old
# commit's, flag for flag.
#
#   bash scripts/old_commit_train_check.sh DIR [COMMIT]
#
# DIR (outside the checkout, e.g. a scratch directory) gets the old package
# (git archive COMMIT nbody_tpu), the dataset, every run's JSON, epoch-loss
# CSV and log, and XLA caches; nothing is written into the checkout. The old
# script's defaults point at results/large_scale/, so every run is given
# --data-dir and --out under DIR. About two minutes on 8 cores.
set -eu
DIR=$(realpath -m "$1"); COMMIT=${2:-d7ef376}
REPO=$(cd "$(dirname "$0")/.." && pwd)
OLD=$DIR/jax_$COMMIT
mkdir -p "$OLD"
[ -d "$OLD/nbody_tpu" ] || git -C "$REPO" archive "$COMMIT" nbody_tpu | tar -x -C "$OLD"
K=(--n-bodies 2000 --train-scenes 2 --steps 40 --stride 4 --batch-size 2 --epochs 3
   --data-dir "$DIR/data")
export OMP_NUM_THREADS=2 JAX_PLATFORMS=cpu
# the dataset once (the port's datagen), then every run on it
(cd "$DIR" && PYTHONPATH="$REPO" python -m nbody_tpu_torch.experiments.train_large "${K[@]}" \
    --epochs 1 --device cpu --out "$DIR/datagen.json" > "$DIR/datagen.log" 2>&1)
run() {  # run NAME PACKAGE_ROOT MODULE FLAG...
    local name=$1 root=$2 module=$3; shift 3
    (cd "$DIR" && NBODY_TPU_COMPILE_CACHE="$DIR/xla_$name" PYTHONPATH="$root" \
        python -m "$module" "${K[@]}" --skip-datagen "$@" --out "$DIR/$name.json" \
        > "$DIR/$name.log" 2>&1) || { echo "$name failed: $DIR/$name.log"; exit 1; }
}
for z in plain zero; do
    f=(); [ $z = zero ] && f=(--zero-init-output)
    run "old_$z" "$OLD" nbody_tpu.experiments.train_large ${f[@]+"${f[@]}"} &
    run "head_$z" "$REPO" nbody_tpu.experiments.train_large ${f[@]+"${f[@]}"} &
    run "port_$z" "$REPO" nbody_tpu_torch.experiments.train_large ${f[@]+"${f[@]}"} \
        --device cpu &
done
wait
python - "$DIR" "$COMMIT" <<'EOF'
import csv, json, os, sys

d, commit = sys.argv[1:]
print(f"| flag | epoch | JAX at {commit} | JAX here | port | port / old - 1 |")
print("| --- | --- | --- | --- | --- | --- |")
for z in ("plain", "zero"):
    loss = {}
    for k in ("old", "head", "port"):
        with open(os.path.join(d, f"{k}_{z}_epoch_loss.csv"), newline="") as f:
            loss[k] = [float(r["loss"]) for r in csv.DictReader(f)]
    for e, (o, h, p) in enumerate(zip(loss["old"], loss["head"], loss["port"]), 1):
        flag = "--zero-init-output" if z == "zero" else "none"
        print(f"| {flag} | {e} | {o!r} | {h!r} | {p!r} | {p / o - 1:.3g} |")
    ev = {k: json.load(open(os.path.join(d, f"{k}_{z}.json")))["eval"]
          for k in ("old", "head", "port")}
    print(f"| {z}: stepwise | - | {ev['old']['stepwise_scaled_rmse']!r} | "
          f"{ev['head']['stepwise_scaled_rmse']!r} | {ev['port']['stepwise_scaled_rmse']!r} "
          f"| baseline {ev['port']['predict_zero_baseline_scaled_rmse']!r} |")
EOF
