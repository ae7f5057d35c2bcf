"""Large-N surrogate training — the port of
``nbody_tpu/experiments/train_large.py``: train a force surrogate on
Barnes-Hut ground truth at 10k to 1M bodies, every stage on the device.

1. datagen: spiral scenes integrated with ``force_backend="bh"``
   (``ops/treeforce.py``), strided snapshots, npz-only datasets;
2. training: ``Trainer.train_from_dir`` with Morton graphs built on the
   device in every step (``batch_mode="bucketed"``), the wall time of each
   epoch recorded, the epoch-loss CSV rewritten after every epoch;
3. eval: the stepwise scaled RMSE on a held-out scene beside the
   predict-zero baseline, then an autoregressive rollout from its step-0
   state: position RMSE against the treecode trajectory at every recorded
   snapshot, and the final state's accelerations against the exact direct
   sum (B1 on the card).

Usage::

    python -m nbody_tpu_torch.experiments.train_large --n-bodies 20000 \\
        --train-scenes 2 --steps 400 --stride 4 --epochs 10
    python -m nbody_tpu_torch.experiments.train_large --n-bodies 1000000 \\
        --neighbors 8 --remat --batch-size 1 --save-every 1

Writes ``results/large_scale/train_<N>.json`` (the JAX script's keys), its
``_epoch_loss.csv`` and the final weights ``_params.pt``. The flags are the
JAX script's. What differs in the port:

- ``--device`` (default cuda; the CPU only as ``--device cpu``), and
  ``device_kind`` in the result;
- ``--conv-impl`` takes ``dense`` or ``kernel`` (the JAX ``xla`` /
  ``pallas``); unset, the ContConv layers choose for themselves (the kernels
  B3-B5 on a card), in training and in the rollout alike;
- ``--conv-node-chunks`` needs no divisibility (a ceil-division of the
  receivers) and is refused with ``--conv-impl dense``;
- the final weights and ``--load-params`` are a ``state_dict`` written by
  ``torch.save`` (``<out>_params.pt``), not a msgpack;
- ``--scan-chunk`` is accepted and recorded, and changes nothing: the port
  dispatches training batch by batch, there is no scan to cut;
- ``--time-chunks`` only cuts the datagen into timed segments.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from nbody_tpu_torch.experiments.common import resolve_device

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="gnn", choices=["gnn", "contconv"],
                   help="surrogate family")
    p.add_argument("--conv-impl", default=None, choices=["dense", "kernel"],
                   help="contconv collect: dense (plain torch) or kernel (B3 with "
                        "B4/B5 as its backward; their plain versions on the CPU); "
                        "unset, the layers take the kernels on a CUDA device")
    p.add_argument("--conv-node-chunks", type=int, default=0,
                   help="contconv kernel path: process the receivers in this many "
                        "sequential chunks per layer, each rematerialised in the "
                        "backward, so that no (N k, channels) tensor of gathered "
                        "features outlives its chunk (the 1M-body memory switch)")
    p.add_argument("--n-bodies", type=int, default=20_000)
    p.add_argument("--train-scenes", type=int, default=2)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--bh-near", type=int, default=48)
    p.add_argument("--bh-refresh", type=int, default=4)
    p.add_argument("--time-chunks", type=int, default=1,
                   help="run datagen as this many sequentially timed segments")
    p.add_argument("--epochs", type=int, default=10,
                   help="epochs to run in this invocation: with --save-every a "
                        "relaunched run resumes from the latest checkpoint and runs "
                        "this many more (the epoch-loss CSV keeps the earlier rows)")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--gnn-dim", type=int, default=64)
    p.add_argument("--remat", action="store_true",
                   help="recompute each EdgeConv in the backward pass instead of "
                        "keeping its (N, k, dim) tensors (GraphModel.remat)")
    p.add_argument("--zero-init-output", action="store_true",
                   help="zero-init the output head: the net starts at pred = 0 "
                        "instead of noise far above the ~1e-7 targets")
    p.add_argument("--output-scale", type=float, default=1e6,
                   help="the net predicts y * scale and divides it out "
                        "(GraphModel.output_scale); 1.0 restores raw targets")
    p.add_argument("--rollout-steps", type=int, default=0,
                   help="rollout horizon of the eval (0 = up to the last recorded "
                        "ground-truth snapshot)")
    p.add_argument("--graph-refresh", type=int, default=8)
    p.add_argument("--scan-chunk", type=int, default=None,
                   help="recorded in the result and otherwise without effect: the "
                        "port dispatches training batch by batch, so there is no "
                        "scan whose length this could cap")
    p.add_argument("--data-dir", default="results/large_scale/data")
    p.add_argument("--out", default=None)
    p.add_argument("--load-params", default=None,
                   help="skip training: load final weights from this state_dict "
                        "file (written by a previous run next to its result JSON) "
                        "and run the eval stages only")
    p.add_argument("--train-time-budget", type=float, default=0,
                   help="stop the epoch loop after this many seconds of training "
                        "(finishing the current epoch), so that the eval always "
                        "runs; 0 = no budget")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every E epochs into <out>_ckpt/ and resume from "
                        "the latest on restart")
    p.add_argument("--skip-datagen", action="store_true",
                   help="reuse existing npz datasets")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    return p


def build_model(args, dev: torch.device):
    """The surrogate of ``--model`` with seeded initial weights."""
    impl = "kernel" if dev.type == "cuda" else "dense"
    gen = torch.Generator().manual_seed(0)
    if args.model == "contconv":
        from nbody_tpu_torch.models import ContinuousConvModel

        # reference recipe (configs/contconv_adopted.json) with the large-N
        # switches: Morton radius search, output_scale
        return ContinuousConvModel(
            in_channels=4, out_channels=3, filter_resolution=(6, 4), radius=1.0,
            agg="mean", self_loops=True, continuous_conv_layers=2,
            continuous_conv_dim=128, encoder_hiddens=(32, 64), decoder_hiddens=(64, 32),
            scale_factor=1e6, radius_method="morton", radius_impl=impl,
            zero_init_output=args.zero_init_output, output_scale=args.output_scale,
            conv_impl=args.conv_impl, conv_node_chunks=args.conv_node_chunks,
            generator=gen)
    from nbody_tpu_torch.models import GraphModel

    return GraphModel(
        input_dim=4, gnn_dim=args.gnn_dim, message_passing_steps=2, aggr="mean",
        neighbors=args.neighbors, scale_factor=1e6, knn_method="morton", knn_impl=impl,
        fused_edgeconv=True,  # same function and parameters, one k-sized tensor a layer
        zero_init_output=args.zero_init_output, output_scale=args.output_scale,
        remat=args.remat, generator=gen)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    import pandas as pd

    from nbody_tpu_torch.data.dataset import SnapshotDataset
    from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset, valid_npz
    from nbody_tpu_torch.ops.pairwise import accelerations
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.train.optim import PlateauScheduler
    from nbody_tpu_torch.train.rollout import autoregressive_rollout
    from nbody_tpu_torch.train.trainer import Trainer

    n = args.n_bodies
    tag = f"{n // 1000}k" if n % 1000 == 0 else str(n)
    data_dir = args.data_dir + tag
    train_dir = os.path.join(data_dir, "train")
    test_dir = os.path.join(data_dir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)

    def scenario(seed):
        # no energies: the exact pairwise PE per snapshot is O(N^2), and
        # training never reads the energy columns
        return ScenarioConfig(
            n_bodies=n, integrator="leapfrog", sim_type="spiral", steps=args.steps,
            dt=DT, softening=EPS, g=G, seed=seed, force_backend="bh",
            bh_near=args.bh_near, bh_refresh=args.bh_refresh, calc_energy=False)

    # --- stage 1: treecode ground truth ----------------------------------
    t0 = time.perf_counter()
    scenes = [(os.path.join(train_dir, f"train_{i}.csv"), 42 + i)
              for i in range(args.train_scenes)]
    test_csv = os.path.join(test_dir, "test.csv")
    for path, seed in scenes + [(test_csv, 1042)]:
        # an existing scene is trusted only if it is a complete zip; a
        # truncated one is generated again (the writer replaces atomically)
        if args.skip_datagen and valid_npz(path[:-4] + ".npz"):
            continue
        generate_dataset([scenario(seed)], path, snapshot_stride=args.stride,
                         write_csv_file=False, vmap_scenes=False,
                         time_chunks=args.time_chunks, device=dev)
    datagen_s = time.perf_counter() - t0
    print(f"datagen: {datagen_s:.1f}s", flush=True)

    # --- stage 2: train ---------------------------------------------------
    model = build_model(args, dev).to(dev)
    trainer = Trainer(model, learning_rate=args.lr, dt=DT, seed=0,
                      scheduler=PlateauScheduler(lr=args.lr, factor=0.25, patience=5))
    mtag = "" if args.model == "gnn" else f"_{args.model}"
    out = args.out or f"results/large_scale/train_{tag}{mtag}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    stem = out[:-5]
    csv_path = stem + "_epoch_loss.csv"
    params_path = stem + "_params.pt"

    epoch_walls = []
    last = [time.perf_counter()]

    def write_epoch_csv(e, losses, mses):
        # `e` is the trainer's resume-aware counter, so a resumed run's rows
        # go on from the earlier numbering, and the rows below the resume
        # epoch are kept from the existing CSV
        new = pd.DataFrame({"epoch": np.arange(e - len(losses) + 1, e + 1),
                            "loss": losses, "mse_loss": mses,
                            "wall_s": epoch_walls[:len(losses)]})
        first = int(new["epoch"].iloc[0])
        if first > 1 and os.path.exists(csv_path):
            old = pd.read_csv(csv_path)
            new = pd.concat([old[old["epoch"] < first], new], ignore_index=True)
        new.to_csv(csv_path, index=False)

    train_t0 = time.perf_counter()

    def on_epoch(e, losses, mses):
        now = time.perf_counter()
        epoch_walls.append(now - last[0])
        last[0] = now
        write_epoch_csv(e, losses, mses)
        # a graceful stop: the eval must still get its time
        return bool(args.train_time_budget and now - train_t0 > args.train_time_budget)

    if args.load_params:
        model.load_state_dict(torch.load(args.load_params, map_location=dev,
                                         weights_only=True))
        losses, mses = [float("nan")], [float("nan")]
        train_s = 0.0
        print(f"loaded params from {args.load_params}", flush=True)
    else:
        t0 = time.perf_counter()
        losses, mses = trainer.train_from_dir(
            train_dir, epochs=args.epochs, batch_size=args.batch_size,
            batch_mode="bucketed", verbose=True, on_epoch_end=on_epoch,
            save_every=args.save_every,
            save_path=(stem + "_ckpt") if args.save_every else None)
        train_s = time.perf_counter() - t0
        print(f"train: {train_s:.1f}s, final loss {losses[-1]:.4f}", flush=True)
        if dev.type == "cuda":
            print(f"peak device memory so far: "
                  f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB", flush=True)
        # the final weights first thing after training, next to the result
        # JSON: a failed eval is then rerun with --load-params
        torch.save(model.state_dict(), params_path + ".tmp")
        os.replace(params_path + ".tmp", params_path)
        print(f"wrote {params_path} ({os.path.getsize(params_path) / 1024:.0f} KiB)",
              flush=True)

    # the training snapshots leave the device before the eval: at 1M bodies
    # they are 40 MB each
    trainer.free_caches()

    # --- stage 3: eval ----------------------------------------------------
    model.eval()
    test_ds = SnapshotDataset.from_file(test_csv)
    traj = test_ds.scene_trajectory(0)
    b = test_ds.buckets[n]
    step_idx = np.sort(np.asarray(b.step[b.scene == 0]))

    # stepwise: the 1-step scaled RMSE over all recorded test snapshots
    sw = []
    with torch.no_grad():
        for i in range(b.x.shape[0]):
            x = torch.from_numpy(b.x[i][None]).to(dev)
            y = torch.from_numpy(b.y[i][None]).to(dev)
            idx, valid = build_graph(model.graph_spec, x[..., :3])
            pred = model(x, idx, valid)
            sw.append(float(torch.sqrt(((model.scale_factor * (pred - y)) ** 2).mean())))
    stepwise = float(np.mean(sw))
    # a model that predicts zero scores scale_factor * rms(y) on this loss:
    # anything above it has learned nothing
    zero_baseline = float(model.scale_factor * np.sqrt((np.asarray(b.y) ** 2).mean()))
    print(f"stepwise scaled RMSE: {stepwise:.4f} "
          f"(predict-zero baseline {zero_baseline:.4f})", flush=True)

    # training and stepwise results are written before the rollout, so that
    # a rollout that fails at large N does not lose them
    prior_training = None
    if args.load_params and os.path.exists(out):
        with open(out) as f:  # an eval-only rerun keeps the run's training record
            prior_training = json.load(f).get("training")
    result = {
        "n_bodies": n,
        "model": args.model,
        "device": "gpu" if dev.type == "cuda" else dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dataset": {
            "train_scenes": args.train_scenes, "steps": args.steps,
            "stride": args.stride, "bh_near": args.bh_near,
            "datagen_seconds": round(datagen_s, 1),
            "snapshots_per_scene": int(np.ceil(args.steps / args.stride)),
        },
        "training": {
            "epochs": args.epochs, "batch_size": args.batch_size,
            "lr": args.lr, "output_scale": args.output_scale,
            "neighbors": args.neighbors, "scan_chunk": args.scan_chunk,
            "remat": bool(args.remat),
            "final_scaled_rmse": losses[-1],
            "first_scaled_rmse": losses[0],
            "seconds_total": round(train_s, 1),
            "seconds_per_epoch": [round(w, 2) for w in epoch_walls],
        },
        "eval": {
            "stepwise_scaled_rmse": stepwise,
            "predict_zero_baseline_scaled_rmse": zero_baseline,
        },
    }
    if prior_training is not None:
        result["training"] = prior_training
        result["eval"]["params_loaded_from"] = args.load_params
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    if not args.load_params:
        write_epoch_csv(trainer.epoch, losses, mses)
    print(f"wrote {out} (pre-rollout)", flush=True)

    # rollout against the treecode trajectory and the exact forces
    horizon = args.rollout_steps or int(step_idx[-1])
    pos0 = torch.from_numpy(np.ascontiguousarray(traj.pos[0])).to(dev)
    vel0 = torch.from_numpy(np.ascontiguousarray(traj.vel[0])).to(dev)
    mass = torch.from_numpy(np.ascontiguousarray(traj.mass)).to(dev)
    t0 = time.perf_counter()
    ps, _, accs = autoregressive_rollout(model, pos0, vel0, mass, horizon + 1, DT,
                                         graph_refresh=args.graph_refresh)
    a_pred = accs[-1].cpu().numpy()
    p_end = ps[horizon].clone()
    ps_np = ps.cpu().numpy()
    rollout_s = time.perf_counter() - t0
    del ps, accs

    rows = []
    for j, s in enumerate(step_idx):
        if s > horizon:
            break
        rmse = float(np.sqrt(((ps_np[int(s)] - traj.pos[j]) ** 2).sum(-1).mean()))
        rows.append({"step": int(s), "pos_rmse": rmse})

    # the final state's forces against the exact direct sum
    a_exact = accelerations(p_end, mass, G, EPS).cpu().numpy()
    num = np.linalg.norm(a_pred - a_exact, axis=1)
    den = np.maximum(np.linalg.norm(a_exact, axis=1), 1e-30)
    acc_med = float(np.median(num / den))
    acc_rmse = float(np.sqrt((num ** 2).mean()))
    # |a| is heavy-tailed (hot centre, cold outskirts): the error relative
    # to the field's own RMS is the fair scalar beside the per-body median
    acc_rel_rmse = float(acc_rmse / np.sqrt((a_exact ** 2).mean()))

    result["eval"].update({
        "rollout_horizon": horizon,
        "rollout_seconds": round(rollout_s, 2),
        "rollout_pos_rmse": rows,
        "final_acc_median_rel_err_vs_exact": acc_med,
        "final_acc_rmse_vs_exact": acc_rmse,
        "final_acc_rel_rmse_vs_exact": acc_rel_rmse,
    })
    print(json.dumps({"final_loss": losses[-1], "stepwise": stepwise,
                      "zero_baseline": zero_baseline,
                      "final_pos_rmse": rows[-1]["pos_rmse"] if rows else None,
                      "acc_med_rel_err": acc_med, "acc_rel_rmse": acc_rel_rmse}), flush=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}", flush=True)
    return result


if __name__ == "__main__":
    main()
