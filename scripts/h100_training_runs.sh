#!/bin/bash
# The JAX package's surrogate training configurations through the port, on
# one CUDA card: the eight results/large_scale/train_*.json configurations at
# their artifacts' knobs, the committed 1M weights' eval, and the two
# 100-epoch reference experiments with run_experiments.sh's own flags. Each lane
# runs in its own process beside the others (they share the card); the lanes
# are independent except that the reference lanes share one dataset, made
# before any lane starts.
#
#   scripts/h100_training_runs.sh OUT LANE ...
#
# Lanes:
#   small        train_20k, train_50k, train_100k, train_20k_contconv
#   cc100k       train_100k_contconv_r3, train_100k_contconv
#   r3           train_100k_r3
#   1m           train_1m, train_1m_r3 (both on one 1M dataset, made once) and
#                train_1m_committed_weights (eval of results/large_scale/
#                train_1m_params.pt on that data)
#   train:NAME   the one answer NAME (any name the runner knows), on data of its
#                own that it makes
#   ics          scripts/ic_realizations.py at 1M on the port's ICs, and on the
#                JAX package's arrays where CARRY/jax_ics_1m.npz (its
#                --dump-jax) is there
#   refdata      the reference datasets made twice more, their digests beside
#                OUT/ref_data.sha256 (is the datagen repeatable on one card?)
#   gnn:E[:S]    E more epochs of gnn_experiment, resumed from the latest
#                checkpoint, then its eval; S seconds at most (the epoch under
#                way when they run out is lost, and the eval takes the latest
#                checkpoint); E = 0 runs the eval alone
#   contconv:E[:S]  the same for contconv_experiment
#
# The reference lanes take their flags from run_experiments.sh's two lines
# (scripts/h100_treecode_runs.py --ref-argv NAME) and add only placement
# (--base, --epochs, --save-every); each command line as run goes into
# OUT/NAME/commands.txt.
#
# Each train_large run takes its knobs from its JAX artifact through
# scripts/h100_treecode_runs.py --argv NAME (what the artifact records, then
# the flags it leaves out, each with its source); a lane adds only where the
# files go. OUT gets every lane's log, the train_large JSONs and epoch-loss
# CSVs (the final weights go to WORK), each run's command line in
# OUT/train_commands.txt, and
# for the reference lanes this call's epoch_loss.csv (the experiments write
# the losses of the current call only: join the calls' files in order), the
# result CSVs once evaluated, and the latest checkpoint. WORK (default _h100,
# git-ignored) holds the datasets and checkpoints; CARRY (default
# _h100carry) is read for a checkpoint to resume from when WORK has none, so
# a checkpoint brought back from an earlier call's OUT continues there. The
# reference datasets are regenerated from their seeds when WORK lacks them;
# their digests (without the step_time column) go into OUT/ref_data.sha256,
# which must match between calls that resume one run. The reference lanes
# run with WORK/ref as their working directory and --base ., so their dataset
# paths are run_experiments.sh's own (./data/train/...): the batch order is
# seeded from those paths, and so is the JAX package's reference runs'. They
# never run in the checkout, whose results/gnn/ and results/contconv/ hold the
# JAX package's answers.
set -u
ROOT=$(cd "$(dirname "$0")/.." && pwd -P)
OUT=$1; shift
WORK=${WORK:-_h100}
CARRY=${CARRY:-_h100carry}
mkdir -p "$OUT/logs" "$WORK/ref"
if [ "$(cd "$WORK/ref" && pwd -P)" = "$ROOT" ]; then
    echo "WORK/ref is the checkout: the reference lanes would write over results/"; exit 2
fi
export OMP_NUM_THREADS=${OMP_NUM_THREADS:-2} PYTHONUNBUFFERED=1
T0=$(date +%s)
stamp() { echo "[$(( $(date +%s) - T0 )) s] $*"; }
clock() { while IFS= read -r line; do echo "[$(( $(date +%s) - T0 )) s] $line"; done; }
# digests of a dataset's CSVs without their step_time column (a wall-clock
# reading, so the one column that differs between two runs of the datagen)
digests() { (cd "$1" && for f in data/*/*.csv; do
    echo "$(cut -d, -f1-3,5- "$f" | sha256sum | cut -c1-64)  $f"; done); }

large() {  # large NAME ARG... : one train_large run at NAME's knobs, placed by
    # ARG..., its JSON and CSV into OUT
    local name=$1; shift
    local knobs
    mapfile -t knobs < <(python scripts/h100_treecode_runs.py --argv "$name")
    [ "${#knobs[@]}" -gt 0 ] || { stamp "train_large $name: no knobs"; return 1; }
    local argv=("${knobs[@]}" "$@" --out "$OUT/$name.json")
    echo "$name: python -m nbody_tpu_torch.experiments.train_large ${argv[*]}" \
        >> "$OUT/train_commands.txt"
    stamp "train_large $name: start"
    python -m nbody_tpu_torch.experiments.train_large "${argv[@]}"
    stamp "train_large $name: exit $?"
    # the final weights stay in WORK, so that OUT holds only the small files
    mv "$OUT/${name}_params.pt" "$WORK/" 2>/dev/null
}

lane_small() {
    local d=$WORK/data
    large train_20k --data-dir "$d"
    large train_50k --data-dir "$d"
    large train_100k --data-dir "$d"
    large train_20k_contconv --skip-datagen --data-dir "$d"
}

lane_cc100k() {  # train_100k's data (made here if missing), then the 4-scene data
    large train_100k_contconv_r3 --skip-datagen --data-dir "$WORK/data_r3_"
    large train_100k_contconv --skip-datagen --data-dir "$WORK/data"
}

lane_r3() {  # on the 4-scene data that lane cc100k makes when it runs beside
    if [[ " $* " == *" cc100k "* ]]; then
        until [ -f "$WORK/data_r3_100k/test/test.npz" ]; do sleep 10; done
    fi
    large train_100k_r3 --skip-datagen --data-dir "$WORK/data_r3_"
}

lane_1m() {
    local d=$WORK/data1m_
    large train_1m --save-every 1 --data-dir "$d"
    rm -rf "$OUT/train_1m_ckpt"
    large train_1m_r3 --skip-datagen --data-dir "$d"
    large train_1m_committed_weights --skip-datagen --data-dir "$d"
}

lane_refdata() {
    local d
    for d in a b; do
        python -c "
from nbody_tpu_torch.experiments.common import generate_data
generate_data('$WORK/ref_$d/data/train', num_files=10, seed=42)
generate_data('$WORK/ref_$d/data/test', num_files=1, seed=43)"
        digests "$WORK/ref_$d" > "$OUT/ref_data_$d.sha256"
        stamp "reference datasets again ($d)"
    done
}

lane_ics() {  # the 1M eval's readings on the port's ICs (JAX's galaxies), and on the
    # JAX package's own arrays where CARRY holds them
    local jax=()
    [ -f "$CARRY/jax_ics_1m.npz" ] && jax=(--jax "$CARRY/jax_ics_1m.npz")
    python scripts/ic_realizations.py ${jax[@]+"${jax[@]}"} --n-bodies 1000000 \
        --seeds 42 43 1042 1043 1044 1045 1046 1047 --out "$OUT/ic_realizations_1m.json"
}

ref_run() {  # ref_run NAME SECONDS ARG... : NAME_experiment with run_experiments.sh's
    # flags and ARG... (placement only), its command line into OUT/NAME/commands.txt
    local name=$1 secs=$2; shift 2
    local flags
    mapfile -t flags < <(python "$ROOT/scripts/h100_treecode_runs.py" --ref-argv "$name")
    [ "${#flags[@]}" -gt 0 ] || { stamp "${name}_experiment: no flags"; return 1; }
    local argv=("${flags[@]}" "$@")
    mkdir -p "$OUT/$name"
    echo "python -m nbody_tpu_torch.experiments.${name}_experiment ${argv[*]}" \
        >> "$OUT/$name/commands.txt"
    timeout -s TERM "$secs" python -m "nbody_tpu_torch.experiments.${name}_experiment" \
        "${argv[@]}" 2>&1 | clock
    return "${PIPESTATUS[0]}"
}

lane_ref() {  # lane_ref gnn|contconv EPOCHS [SECONDS], in WORK/ref at --base .
    local name=$1 epochs=$2 secs=${3:-0} rc
    local ckpts=$WORK/ref/${name}_weights
    if [ -z "$(ls "$ckpts" 2>/dev/null)" ] && [ -d "$CARRY/${name}_weights" ]; then
        mkdir -p "$ckpts" && cp "$CARRY/${name}_weights"/ckpt_*.pt "$ckpts"/
    fi
    OUT=$(cd "$OUT" && pwd -P)  # the lane runs in a subshell of its own
    cd "$WORK/ref" || return 1
    export PYTHONPATH=$ROOT${PYTHONPATH:+:$PYTHONPATH}
    stamp "${name}_experiment: $epochs more epochs from $(ls "${name}_weights" 2>/dev/null)"
    rm -f "results/$name/epoch_loss.csv"
    [ "$secs" -gt 0 ] || secs=0  # timeout 0: no limit
    ref_run "$name" "$secs" --base . --epochs "$epochs" --save-every 1
    rc=$?
    stamp "${name}_experiment: exit $rc"
    if [ "$rc" = 124 ]; then  # out of time: evaluate the epochs reached
        ref_run "$name" 0 --base . --epochs 0
        stamp "${name}_experiment eval of the latest checkpoint: exit $?"
    fi
    mkdir -p "$OUT/$name/${name}_weights"
    cp "results/$name"/*.csv "$OUT/$name/" 2>/dev/null
    local last
    last=$(ls "${name}_weights" 2>/dev/null | grep -E '^ckpt_[0-9]+\.pt$' | sort -t_ -k2 -n | tail -n 1)
    [ -n "$last" ] && cp "${name}_weights/$last" "$OUT/$name/${name}_weights/"
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
df -h "$WORK" | tail -n 1
for lane in "$@"; do
    case $lane in gnn:*|contconv:*)
        # the reference experiments' shared dataset: run_experiment's datagen
        # with --seed 42 (train) and 43 (test), once for every lane
        python -c "
from nbody_tpu_torch.experiments.common import generate_data
generate_data('$WORK/ref/data/train', num_files=10, seed=42)
generate_data('$WORK/ref/data/test', num_files=1, seed=43)"
        stamp "reference datasets ready"
        digests "$WORK/ref" > "$OUT/ref_data.sha256"
        break;;
    esac
done
pids=()
for lane in "$@"; do
    IFS=: read -r name a b <<< "$lane"
    case $name in
        small|cc100k|r3|1m|ics|refdata) "lane_$name" "$@" > "$OUT/logs/$name.log" 2>&1 & ;;
        gnn|contconv) lane_ref "$name" "$a" "${b:-0}" > "$OUT/logs/$name.log" 2>&1 & ;;
        train) large "$a" --skip-datagen --data-dir "$WORK/${a}_data" \
            > "$OUT/logs/$a.log" 2>&1 & ;;
        *) echo "unknown lane $lane"; exit 2;;
    esac
    pids+=($!)
done
for p in "${pids[@]}"; do wait "$p"; done
stamp "all lanes done"
grep -h "train_large .*exit\|experiment: exit\|Traceback\|Error" "$OUT"/logs/*.log
