#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``nbody_tpu_torch/csrc`` and drives
the port's main path once:

0. device and build: the card's name and power limit, full-f32 matmuls, the
   kernels built with nvcc for sm_90a; (b) ``utils.prng``, JAX's keyed
   random streams, on the card: JAX's known answers, 100,000 draws of each
   kind the CPU's bits, the card's 100,000-body spiral against the CPU's,
   and the time of a 10,000,000-body spiral drawn on the card; every galaxy
   of the phases below is drawn from ``prng.PRNGKey``; (c) flax's streams
   (``models/init.py``): both reference configurations' initial models
   from ``split(PRNGKey(0))[1]`` drawn on the card, JAX's known answers and
   every parameter the CPU's bits, and one step's dropout mask the CPU's;
   every model below is drawn from a key (a trainer's from its seed);
1. every kernel against its plain-torch twin on spiral initial conditions,
   with kernel and twin times (B2 also its device time and kernels a call),
   and the kernel simulate path against the dense one;
2. the reference-recipe datagen through ``nbody_tpu_torch.cli.datagen`` (six
   spiral scenes of 3-500 bodies, 1000 leapfrog steps, energy columns), with
   the kernels' launch counters checked and the 500-body energy drift
   bounded; after the counts of phases 2-4 are read, 20 steps of its
   500-body scene under the profiler: one B2 kernel an energy;
   (b) grouped datagen at the recipe width: ``generate_dataset`` on 8 spiral
   scenes of 500 bodies differing only by seed (scene groups on), then the
   same list one scene at a time: B1 and B2 once a step for the group, the
   same bits either way (both npz only), each scene's drift bounded, and
   the group's kernels a step under the profiler; then the same 8 scenes
   for CSV_STEPS steps, grouped, with their CSV: the native writer's, and
   the same bytes as every scene's rows written again through it;
   (c) 4 scenes of 20,000 bodies for 200 steps grouped against one by one:
   the same bits, the drift bounded, B1's and B2's grouped times beside
   4 single-scene calls and their bound;
3. one 20,000-body spiral scene of 200 steps with energies; after the
   counts are read, B2's share of 20 more steps' device time;
4. the EdgeConv surrogate at the reference width (JAX's initial weights of
   ``PRNGKey(0)``): stepwise and 500-step rollout evaluation over the
   phase-2 dataset, then a 50-step rollout at 20,000 bodies;
5. the large-N kernels against their twins on spiral initial conditions:
   the Morton select (B7) and merge (B8) at 20,000 and 100,000 bodies for
   kNN(10) and the radius search's k = 32 with self edges (and kNN(8), the
   1M GNN's, at 100,000), recall against
   exact kNN, the ContConv collect (B3) on the geometry of a Morton radius
   graph at D = 6 and 4, twice for the same bits, with the (receiver, cell)
   pair plan that B3 and B4 share against its plain version (ids, order and
   offsets equal), and the full-width ContinuousConvModel on the card
   against the CPU;
6. the large-N surrogate path through
   ``nbody_tpu_torch.experiments.large_scale`` at 100,000 bodies, 20 steps,
   modes direct, surrogate and hybrid, for the reference-width ContConv
   model and the GNN with Morton kNN;
7. the backward of B3 against its plain version: B4 (filters), B5
   (features) and B6 (geometry) on the 100,000-body Morton radius graph's
   geometry at D = 6 and 4, on one small odd shape and on a geometry with
   coordinates on the integer grid, clamped ones and zero windows, each
   twice for the same bits, with B5's two passes (dG over the pair plan,
   the unbin pass) against their plain versions on the small shape and
   B6's geometry pass against its pair-wise plain version (over the plan
   that keeps the edges of zero window) on each, and B6's device ms at
   100,000 bodies; (c) one shape past each cap that the card kernels once
   had: the collect and its backward at k = 72, co = 136 and D = 11, a
   position gradient at ci = 136, ``knn_morton(impl="kernel")`` at k = 40
   on 20,000 bodies and B8 on 160-wide edge rows; then the full-width
   ContinuousConvModel's parameter and
   position gradients with the kernels against the dense layer (the
   position gradient is the path that launches B6), and B6's device ms and
   bound at that shape;
8. the training path: ``nbody_tpu_torch.experiments.run`` with
   ``configs/contconv_adopted.json`` as it stands, at full width, whose
   layers take the kernels on the card with no override (datagen cut to 2
   files of 200 steps, 2 epochs, a checkpoint each), a
   resumed third epoch and the evaluation from the checkpoints (100-step
   rollouts); the
   recipe-shape training step timed and profiled; ``elastic_train`` on that
   cut with its weights poisoned once (one restart from the last healthy
   checkpoint at the backed-off learning rate); ``gnn_experiment
   --quick``; and the 100,000-body training step (Morton radius search,
   B3 + B4 + B5, batch 1) on a strided port-datagen dataset, with B5's
   share of its device time and its peak memory, beside the dense layer's
   step at the largest N that fits;
9. the treecodes: (a) B9 (far field), B10 (grouped multipoles) and B1's
   near-list form against their plain versions, each twice for the same
   bits, on the shapes of the 100,000-body bh recipe (M=32, B=256) and of
   the 1,000,000-body bh3 recipe (B=128, C=16, rc=48, Bs=32, K=48; B10's
   four launches there: refinement, coarse and near subtraction, sub-block
   multipoles), each timed between events around the wrapper and by its
   kernel's device time from the profiler; (b) each
   engine's kernel path against its dense path on one partition at 100,000
   bodies; (c) ``nbody_tpu_torch.experiments.bh_rollout`` through its
   ``main``: bh at 100,000 bodies for 200 steps with the exact energy audit
   (B2), and bh3 at 1,000,000 bodies for 16 steps in chunks of 8 with the
   sampled force audit; (d) ``treeforce_bench`` at 100,000 bodies for each
   engine;
10. the large-N entry points: (a) B11, the windowed EdgeConv message sum,
    against its plain version at a small odd shape and at 1,000,192 rows
    (k = 8, d = 64, tile 256, half 384), float32 and bfloat16 gather, each
    twice for the same bits; (b) the crossover path's own data at 1M: spiral
    bodies in Morton order, their Morton graph (B7, B8) with the select and
    the merge behind it against their plain versions at that size, its
    recall against the exact search and B1 against its plain version on
    4096 receivers over all 1M sources; ``u'`` and ``v`` of
    the first EdgeConv of the 1M model with the committed trained weights,
    ``edge_message_sum`` (one B11 launch over the plan's in-window and
    fallback edges) against the fused layer's masked tanh sum and against
    its plain version, with the in-window share, the overflow (0) and the
    times of the torch gather, of B11 alone on the in-window edges and of
    ``edge_message_sum``; (c) the
    fused against the unfused ``GraphModel`` forward at 100,000 bodies, with
    each one's peak memory; (d) ``nbody_tpu_torch.experiments.crossover``
    through its ``main``: every mode at 100k, direct, bh3 and the surrogate
    at 1M with the trained weights; (e) ``train_large`` through its ``main``:
    the GNN at 1M with ``--remat`` (2 epochs, a resumed third, an eval-only
    rerun from the saved weights) and the full-width ContConv at 100k with 4
    node chunks beside the unchunked layer; (f) ``knn_recall`` at 100k (its
    ``approx`` rows recall 1.0), then ``knn_neighbors(approx=True)`` at
    20,000 bodies against the exact selection (ids and validity, with and
    without a mask and self edges) and one rollout step of a reference-width
    ``GraphModel(knn_method="approx")``;
11. ``parallel/``: ``parallel.dryrun.check_paths`` on 2 ranks on cuda:0 over
    gloo (NCCL refuses two ranks on one device; gloo moves the tensors
    through host memory), then at world size 1 over NCCL at smaller sizes,
    each rank 0 holding its results to the one-process ones: the ring force
    (two hops of 50k x 50k B1 cross blocks), energies (B2) and a leapfrog
    step at 100,000 bodies, the sharded bh, bh2 and bh3 forces (bh3 at
    1,000,000: B = 128, rc = 48, K = 48) and a 16-step bh rollout (refresh 8)
    at 100,000, the GNN rollout at 100,000 with the committed 1M weights
    (k = 8, fused), the full-width ContConv forward and training gradients at
    20,000, and ``Trainer(mesh=)`` on phase 8a's recipe cut (every step held
    to one process's step from the same parameters), with ms a step sharded
    and in one process beside the card line; the ranks count their
    own launches over the sharded calls only, and each must have launched
    B1, B1's near list, B2, B3-B5 and B7-B10, B6 none (the kernels line
    keeps its entries from the phases above);
12. scene groups: (a) B9, B10's near subtraction and B1's near list on a
    scene axis at the shapes of a 4 x 100,000 bh group (M = 32, B = 256),
    one launch a call, against their plain versions and each scene bit for
    bit its own call; (b) treecode groups through ``simulate``: bh on 4 x
    100,000 bodies (64 steps, refresh 8, exact B2 energies) and bh3 on 2 x
    1,000,000 (B = 128, C = 16, rc = 48, Bs = 32, K = 48, 16 steps, refresh
    8), each group's launches counted (B9 and the near list once a force
    evaluation of the group, B10 once or 4 times), every scene equal to its
    run alone in every field, and ms a step a scene grouped and one by one
    with the idle share from the profiler; (c) a batch's Morton graph, 4 x
    100,000 bodies, k = 32, block 256, 4 copies: one B7 and one B8 launch,
    each scene the ids of its own call, B7 and B8 on the batch against
    their plain versions, with times.
13. the JAX package's 2M-10M treecode configurations through the entry
    points, each driven with the counters at 0 just before it and read just
    after (B9, B10, B1's near list and the audit's B1, or B2, launched), its
    peak memory and wall time on lines of their own: (a) ``bh_rollout`` bh2
    at 10,000,000 bodies (M = 16, B = 512, C = 16, rc = 48, refresh 8), 16
    steps in chunks of 8, the sampled force audit of 4096 receivers, median
    relative error < 0.03 (``results/large_scale/bh_rollout_10m.json``:
    0.0195 after 200 steps); (b) ``treeforce_bench`` bh3 at 10,000,000 at
    ``bh3_10m_tier_rc96.json``'s knobs (M = 48, rc = 96, Bs = 32, K = 64),
    fresh force evaluations with the 4096-receiver audit, median < 0.0105
    (1.5 x the artifact's 0.00698); (c) ``bh_rollout`` bh2 at 2,000,000 (M
    = 32, B = 128, rc = 48), 32 steps with the exact B2 energy at both ends,
    drift < 1e-5. Then, outside those counts: (d) every launch of a bh2
    force evaluation on a 10M partition at (a)'s knobs (B9, B10's
    refinement, coarse and near subtraction, B1's near list with 512
    receivers a group and source blocks of 512) against its plain version;
    (e) bh3 at 10M at ``bh3_10m_tier.json``'s knobs on ``treeforce_bench``'s
    ICs and receivers, the kernel path against the dense path elementwise
    and in the sampled median and p99 of the force error.
14. the JAX package's training configurations at full width, with the
    counters at 0 before them and read after (B1 and B2 in the recipe
    datagen, B3-B5 two launches each a ContConv step, B7-B10, the near list
    and B1 in ``train_large``): (a) the GNN recipe step at
    ``configs/gnn_reference.json`` (width 64, k = 10, batch 64,
    ``batch_mode`` reference, exact kNN) on the recipe cut to 2 train files
    of 1000 steps: ms per optimiser step of one epoch, the idle share and
    top device rows of a profiled window (1 file of 100 steps), then one
    step's 66 exact kNN graphs and the model's forward and backward on them,
    each profiled alone (device ms); (b) the ContConv recipe step at
    ``configs/contconv_adopted.json`` (batch 16, mixed, merged) on the same
    files, the same readings; (c)
    ``train_large`` GNN at 100,000 bodies through its ``main``, at
    ``train_20k``'s command line from ``scripts/h100_treecode_runs.py`` cut
    to 1 scene of 40 steps, stride 4, 2 epochs and the eval, with s per
    epoch, the peak memory and the stepwise error against the predict-zero
    baseline, every number finite; then the same cut (whose line carries
    ``--zero-init-output``, as the 2-scene JAX runs did) for 1 epoch on that
    data: in both runs the first prediction is exactly zero before any
    step, and B7 and B8 launch as often a step.
15. the JAX package's sub-2M sweeps through ``scripts/h100_treecode_runs.py``
    (each row's entry point at the row's own knobs, read from
    ``results/large_scale/``), each artifact's rows driven with the counters
    at 0 just before them and read just after, and held by
    ``scripts/answer_ratios.py``'s bars: ``treeforce_bench`` bh at 1M, M =
    16, B = 512 (``bh.json``, the full exact sum), bh2 at 1M, rc = 12
    (``bh2.json``) and bh3 at ``bh3_1m_rc48_ns64.json``'s knobs (4096
    sampled receivers), each median within 0.8-1.25x JAX's and each p99
    within 0.5-2.0x; ``knn_recall`` on the 100,000-body spiral,
    ``morton(W=64)`` and the kernels' ``morton-pallas(B=256)`` (B7 + B8),
    recall within 5e-4 of JAX's, the exact row 1.0 and the ``approx`` row at
    least JAX's (off the TPU its selection is the exact one); ``crossover``
    direct and surrogate (refresh 8) at 20,000 bodies, 50 steps
    (``crossover_r3.json``), every final state finite.

Every phase raises on failure, so the exit code is non-zero and no result
line is printed. Informative lines come first. The last three lines are a
JSON object with one entry per kernel, B3, B4 and B5 once for each of the
model's two filter resolutions (launches counted over the path that
runs it, its counters set to 0 just before the path and read just after:
phases 2-4 for B1 and B2, phase 2b's grouped run for their scene-group
entries, phase 6 for B3, B7 and B8, phase 8 for B4 and B5,
the phase-7 position gradient for B6, phase 9c for B9, B10 and B1's near
list, phase 12's group rollouts and batched search for their scene-group
entries and B7's and B8's batch entries, phase 10b for B11, which stands
beside the model as in the JAX
package, so that the entry points of 10d and 10e leave it at 0: each of
their ``main`` calls starts with the counters at 0 and is held, right after
it returns and before any profiling helper runs, to the kernels it must
launch, B1, B3-B5, B7-B10 and the near list between them; errors and times
from phases 1, 2b, 5, 7, 9a, 10a and 12; ``bound_ms``, the least
time of the same work on the card, from the operations and bytes of those
inputs, see :func:`bound`), the card's ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

G, EPS, DT = 4.5e-6, 0.05, 1e-4
B1_TOL = 2e-5      # max |da| / max |a| (tests/test_forces.py:56,65)
B2_TOL = 1e-5      # relative PE error (tests/test_forces.py:114-130)
DRIFT_500 = 1e-4   # 500-body leapfrog energy drift over 1000 steps
DRIFT_20K = 1e-3   # 20k-body drift over 200 steps (treecode tests' bar)
RECIPE_N = [3, 25, 50, 100, 250, 500]
SOURCES = ("pairwise", "spatial", "contconv", "treeforce", "edgeconv")
RECIPE_STEPS = 1000
GROUP_SEEDS = range(8)  # phase 2b: 8 recipe scenes of 500 bodies differing by seed
CSV_STEPS = 50          # phase 2b's CSV: the same scenes, 200,000 rows
BIG_GROUP = 4           # phase 2c: scenes of BIG_N bodies in one group
EVAL_STEPS = 500   # rollout evaluation depth (each shape runs once more, untimed, first)
BIG_N, BIG_STEPS, SURR_STEPS = 20_000, 200, 50
LARGE_N, LARGE_STEPS = 100_000, 20
RECALL = 0.99      # Morton kNN recall (tests/test_spatial.py:69-76,132-141)
B3_TOL = 2e-4      # max |dout| / max |out| (tests/test_models.py:161); B4-B6 too
MODEL_RTOL, MODEL_ATOL = 2e-4, 1e-5  # atol times max |a|; gradients too
# (tests/test_models.py:387-391,429-430)
GRAD_N = 2_000     # bodies of the full-width model's card checks
EDGE_ROWS = 8_192  # rows of B8's edge-row checks
# configs/contconv_adopted.json's widths with the Morton radius search
FULL_CONTCONV = dict(in_channels=4, out_channels=3, filter_resolution=(6, 4), radius=1.0,
                     agg="mean", self_loops=True, continuous_conv_layers=2,
                     continuous_conv_dim=128, encoder_hiddens=(32, 64),
                     decoder_hiddens=(64, 32), scale_factor=1e6, radius_method="morton",
                     radius_impl="kernel", conv_impl="kernel")
# the config's own model: its layers take the kernels for card tensors
RUN_SETS = ["datagen.train_files=2", "datagen.steps=200", "train.save_every=1",
            "train.sim_steps=100"]  # rollout evaluation: each shape once untimed, once timed
TRAIN_STEPS, TRAIN_STRIDE = 50, 10  # the 100k dataset: 5 snapshots
# the treecodes: the JAX package's recipes (results/large_scale/bh_rollout*.json)
TREE_N, TREE_1M = 100_000, 1_000_000
BH_100K = dict(n_near=32, block=256)
BH3_1M = dict(n_near=32, block=128, coarse=16, rc=48, sub_block=32, n_sub=48)
MULT_TOL = 1e-5    # B9/B10 against their plain versions, max |d| / max |plain|
# a substring of each treecode kernel's name, as the profiler reports it
B9_NAME, B10_NAME, NEAR_NAME = "multipole_far", "multipole_grouped", "near_force"
NEAR_ATOL = {"bh": 5e-9, "bh2": 5e-9, "bh3": 2e-8}  # kernel vs dense path, rtol 2e-3
# (tests/test_treeforce.py:136-137,241-242,401-402), met at 100k by all but
SEAM_SHARE = 1e-4  # this share of elements (see phase9_engines)
BH_DRIFT = 1e-3    # 100k bh rollout energy drift (tests/test_treeforce.py:120-121)
BH3_MEDIAN = 5e-2  # 1M bh3 sampled median relative force error
B11_TOL = 2e-6     # rtol = atol of B11 against its plain version
# (attic/test_edgeconv_kernel.py:44)
TANH_FLOPS = 20.0  # taken for one float32 tanhf (an exp, a division, a few fmas)
WINDOW = dict(tile=256, half=384)  # the JAX module's defaults
PARAMS_1M = os.path.join(HERE, "results", "large_scale", "train_1m_params.pt")
# the crossover / train_1m GNN (results/large_scale/train_1m.json)
GNN_1M = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean", neighbors=8,
              scale_factor=1e6, knn_method="morton", knn_impl="kernel")
CHUNKS = 4         # node chunks of the 100k ContConv training run
# phase 11, parallel/: 2 ranks on the one card over gloo at these sizes, then
# every function at world size 1 over NCCL at the smaller ones
PAR_N, PAR_1M, PAR_CC_N = 100_000, 1_000_000, 20_000
PAR_SMALL_N, PAR_SMALL_CC_N = 20_000, 5_000
BH2_100K = dict(n_near=32, block=128, coarse=16, rc=48)
# the kernels the sharded paths must launch (B6: parameter gradients only)
PAR_NEED = ("b1", "b1n", "b2", "b3", "b4", "b5", "b7", "b8", "b9", "b10")
SAMPLE_1M = 4096   # receivers of the 1M path's exact-search and direct-sum checks
# phase 12: treecode scene groups at the 100k bh and 1M bh3 recipes' widths,
# (scenes, bodies, steps), refresh 8, and a batch's Morton graph (scenes,
# bodies, k) on the 1M GNN's block and copies
GROUP_BH, GROUP_BH3, GROUP_REFRESH = (4, TREE_N, 64), (2, TREE_1M, 16), 8
MORTON_GROUP = (4, LARGE_N, 32)
# phase 13: the 2M-10M treecode artifacts' knobs (results/large_scale/) and bars
BH2_10M = ["--engine", "bh2", "--bh-near", "16", "--block", "512", "--coarse", "16",
           "--rc", "48"]
BH3_10M_RC96 = ["--engine", "bh3", "--n-near", "48", "--block", "512", "--coarse", "16",
                "--rc", "96", "--sub-block", "32", "--n-sub", "64"]
BH2_2M = ["--engine", "bh2", "--bh-near", "32", "--block", "128", "--coarse", "16",
          "--rc", "48"]
# the same knobs as a partition's (bh2_10m_b512.json, bh3_10m_tier.json)
BH2_10M_PART = dict(n_near=16, block=512, coarse=16, rc=48)
BH3_10M_TIER = dict(n_near=48, block=512, coarse=16, rc=48, sub_block=32, n_sub=48)
BH2_10M_MEDIAN = 0.03   # bh_rollout_10m.json: 0.0195 after 200 steps
BH3_10M_MEDIAN = 0.0105  # 1.5 x bh3_10m_tier_rc96.json's 0.00698
BH2_2M_DRIFT = 1e-5
# phase 15: rows of the JAX package's sub-2M sweeps (results/large_scale/),
# each answered by scripts/h100_treecode_runs.py and held by answer_ratios.py's
# bars; (artifact, JAX row filter, kernels its entry point must launch)
SWEEP_ROWS = [
    ("bh", lambda r: r["n"] == 1_000_000 and r["n_near"] == 16 and r["block"] == 512,
     ("b1", "b1n", "b9", "b10")),
    ("bh2", lambda r: r["n"] == 1_000_000 and r.get("rc") == 12, ("b1", "b1n", "b9", "b10")),
    ("bh3_1m_rc48_ns64", lambda r: True, ("b1", "b1n", "b9", "b10")),
    ("knn_recall", lambda r: (r["profile"], r["n"]) == ("spiral", 100_000)
     and r["method"] in ("exact", "approx", "morton(W=64)", "morton-pallas(B=256)"),
     ("b7", "b8")),
    ("crossover_r3", lambda r: r["n"] == 20_000, ("b1", "b7", "b8")),
]
# phase 14: the recipe cut to 2 train files (configs/*.json: 10), seed 42 as
# in run_experiments.sh; train_large's GNN at 100k cut to 1 scene of 40 steps
TRAIN_CUT_FILES = 2
WINDOW_STEPS = 100  # the profiled window: 1 file of the recipe at 100 steps
# (train_20k's command line from scripts/h100_treecode_runs.py, cut to this size)
TRAIN_LARGE_CUT = ["--n-bodies", str(LARGE_N), "--train-scenes", "1", "--steps", "40",
                   "--stride", "4", "--epochs", "2", "--batch-size", "1", "--rollout-steps", "0"]


# Known answers of ``nbody_tpu_torch.utils.prng``, copied from JAX 0.9 on the
# CPU (``tests/test_torch_prng.py`` holds JAX and the port to them):
# threefry's published vector for key (0, 0) and count (0, 0), and draws of
# ``PRNGKey(42)``. Phase 0b and ``tests/test_torch_gpu.py`` check them on the
# card, where there is no JAX.
KNOWN_ANSWERS = {
    "threefry_00": [0x6B200159, 0x99BA4EFE],
    "split_42_6": [[1832780943, 270669613], [64467757, 2916123636],
                   [2465931498, 255383827], [3134548294, 894150801],
                   [2954079971, 3276725750], [2765691542, 824333390]],
    "bits_42_4": [2098992034, 2919706841, 2646866425, 2409546199],
    "choice_42_1000_4": [955, 914, 121, 753],
    "uniform_42_4": [0.48870956897735596, 0.6797971725463867, 0.6162714958190918,
                     0.5610160827636719],
    "normal_42_4": [-0.02830461598932743, 0.4671318531036377, 0.2957029640674591,
                    0.15354591608047485],
    "gamma2_42_4": [3.6725165843963623, 1.0923854112625122, 3.5018391609191895,
                    1.146207571029663],
}


def known_answers(device=None) -> dict:
    """The port's draws for each entry of ``KNOWN_ANSWERS``, drawn on
    ``device``, as lists."""
    import torch

    from nbody_tpu_torch.utils import prng

    k = prng.PRNGKey(42, device)
    zero = torch.zeros(2, dtype=torch.int64, device=k.device)
    return {
        "threefry_00": [int(w) for w in prng.threefry_2x32(zero[0], zero[1], zero[0], zero[1])],
        "split_42_6": prng.split(k, 6).tolist(),
        "bits_42_4": prng.random_bits(k, 4).tolist(),
        "choice_42_1000_4": prng.choice(k, 1000, (4,)).tolist(),
        "uniform_42_4": prng.uniform(k, 4).tolist(),
        "normal_42_4": prng.normal(k, 4).tolist(),
        "gamma2_42_4": prng.gamma(k, 2.0, 4).tolist(),
    }


def known_answer_mismatches(device=None) -> list:
    """Names of the entries of ``KNOWN_ANSWERS`` that the draws on
    ``device`` miss: every entry bit for bit (floats as float32)."""
    import numpy as np

    def arr(v):
        a = np.asarray(v)
        return a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int64)

    got = known_answers(device)
    return [name for name, want in KNOWN_ANSWERS.items()
            if not np.array_equal(arr(got[name]), arr(want))]


# Known answers of the initial models (``nbody_tpu_torch/models/init.py``):
# the first values of a few flax leaves of both reference configurations'
# models drawn from ``PRNGKey(0)``'s init key, ``split(PRNGKey(0))[1]``,
# copied from ``jax.jit(model.init)`` (JAX 0.9, Flax 0.12, CPU;
# ``tests/test_torch_flax_init.py`` holds JAX and the port to them).
INIT_KNOWN_ANSWERS = {
    "gnn/EdgeConv_0/Dense_0/kernel": [-0.038854505866765976, -0.03841238468885422,
                                      -0.25455567240715027, 0.2057279497385025],
    "gnn/EdgeConv_1/Dense_1/bias": [0.09818804264068604, -0.09256896376609802,
                                    -0.037334978580474854, -0.09418684244155884],
    "gnn/OutputHead_0/Dense_0/kernel": [0.11670973151922226, 0.004411700647324324,
                                        -0.018527014181017876, 0.08726978302001953],
    "contconv/MLP_0/Dense_0/kernel": [-0.2451390027999878, -0.45490705966949463,
                                      0.43691563606262207, -0.12301206588745117],
    "contconv/MLP_0/Dense_1/bias": [-0.08366638422012329, 0.004427863750606775,
                                    -0.09716706722974777, -0.11459457874298096],
    "contconv/ContinuousConv_0/filters": [-0.5277038216590881, 0.1619403213262558,
                                          -2.736171007156372, -1.3793786764144897],
    "contconv/ContinuousConv_1/filters": [0.0029054409824311733, -1.0645835399627686,
                                          1.4939717054367065, -1.2173986434936523],
    "contconv/OutputHead_0/Dense_1/kernel": [0.07679480314254761, -0.037468403577804565,
                                             0.030574917793273926, 0.12390217185020447],
}


def _reference_models():
    """The models of ``configs/gnn_reference.json`` and
    ``configs/contconv_adopted.json``, waiting for their weights."""
    from nbody_tpu_torch.config import ExperimentConfig

    return {name: ExperimentConfig.load(os.path.join(HERE, "configs", f)).build_model()
            for name, f in (("gnn", "gnn_reference.json"),
                            ("contconv", "contconv_adopted.json"))}


def init_known_answers(device=None) -> dict:
    """The port's draws of each entry of ``INIT_KNOWN_ANSWERS``, drawn on
    ``device``, as lists."""
    from nbody_tpu_torch.models.init import contconv_model_variables, graph_model_params
    from nbody_tpu_torch.utils import prng

    key = prng.split(prng.PRNGKey(0, device))[1]
    models = _reference_models()
    trees = {"gnn": graph_model_params(models["gnn"], key),
             "contconv": contconv_model_variables(models["contconv"], key)["params"]}
    out = {}
    for name, want in INIT_KNOWN_ANSWERS.items():
        model, *path = name.split("/")
        leaf = trees[model]
        for part in path:
            leaf = leaf[part]
        out[name] = leaf.reshape(-1)[:len(want)].tolist()
    return out


def init_known_answer_mismatches(device=None) -> list:
    """Names of the entries of ``INIT_KNOWN_ANSWERS`` that the draws on
    ``device`` miss, bit for bit as float32."""
    import numpy as np

    got = init_known_answers(device)
    return [name for name, want in INIT_KNOWN_ANSWERS.items()
            if not np.array_equal(np.asarray(got[name], np.float32),
                                  np.asarray(want, np.float32))]


def log(msg: str) -> None:
    print(msg, flush=True)


T0 = time.perf_counter()


def stamp(label: str) -> None:
    """Seconds since the script started, after the phase ``label``."""
    log(f"[t] {label} done at {time.perf_counter() - T0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the least time of work that does ``flops``
    FP32 operations and moves ``nbytes`` (each input read once, each output
    written once), the larger of the two at an H100's published peaks
    (``nbody_tpu_torch.utils.timing.bound_ms``)."""
    from nbody_tpu_torch.utils.timing import bound_ms

    return bound_ms(flops, nbytes)


def collect_bound(gx, gy, gz, win, ci: int, co: int, d: int, other_bytes: float):
    """(bound_ms, bound_by) of B3-B5 on one geometry: per touched (receiver,
    cell) pair a ci x co product (2 ci co flops), per edge corner a ci-wide
    weighted feature sum (2 ci). The pairs are counted from these inputs:
    corners of nonzero weight on edges of nonzero window. Bytes: the four
    (M, k) geometry inputs, the (M, k, ci) features (or, for B5, their
    cotangent), the (D^3, ci, co) filters (or, for B4, their cotangent) and
    ``other_bytes`` of the kernel's other operands and outputs. B6's own
    work is ``contconv_bench.b6_bound_ms``."""
    import torch

    from nbody_tpu_torch.ops.interpolate import trilinear_corners

    m, k = win.shape
    touched, rows = 0, max(1, (1 << 22) // k)
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        cidx, cw = trilinear_corners(torch.stack([gx[sl], gy[sl], gz[sl]], -1).reshape(-1, 3), d)
        live = (cw != 0) & (win[sl].reshape(-1, 1) != 0)
        recv = torch.arange(r0, r0 + win[sl].shape[0], device=win.device).repeat_interleave(k)
        keys = recv[:, None].expand_as(cidx)[live] * d ** 3 + cidx[live].long()
        touched += torch.unique(keys).numel()
    flops = 2.0 * touched * ci * co + 2.0 * 8 * m * k * ci
    nbytes = 4.0 * (4 * m * k + m * k * ci + d ** 3 * ci * co) + other_bytes
    return bound(flops, nbytes)


def select_merge_bounds(cand, ids, mc, m_ids, k: int, block: int):
    """(B7's, B8's) (bound_ms, bound_by) on one Morton search: B7 per
    (query, candidate of its 3-block window) ~8 flops of distance and a
    compare; B8 per row, k passes of a min and a mask over its candidates."""
    c_, L = cand.shape[0], cand.shape[1]
    b7 = bound(9.0 * c_ * ids.shape[1] * 3 * block, 16.0 * c_ * L + 8.0 * ids.numel())
    b8 = bound(2.0 * mc.shape[0] * k * mc.shape[1], 8.0 * mc.numel() + 8.0 * m_ids.numel())
    return b7, b8


def rel_drift(u, k) -> float:
    import numpy as np

    e = np.asarray(u, np.float64) + np.asarray(k, np.float64)
    return float(np.abs(e - e[0]).max() / abs(e[0]))


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its short name; each counts its
    launches in ``.launches``."""
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops import treeforce as tf

    return {"b1": pw.partial_accelerations, "b2": pw.pair_potential,
            "b3": cck.contconv_collect, "b4": cck.contconv_bwd_filters,
            "b5": cck.contconv_bwd_feat, "b6": cck.contconv_bwd_geom,
            "b7": sp.morton_select, "b8": sp.morton_merge,
            "b9": tf.multipole_acc, "b10": tf.grouped_multipole_acc,
            "b1n": pw.near_accelerations, "b11": ek.windowed_tanh_sum}


def zero_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by_d"):  # B3-B5: also by filter resolution
            w.launches_by_d.clear()


def by_resolution(key: str) -> dict:
    """B3's, B4's or B5's launches since :func:`zero_counts` at D = 6 and D = 4,
    the two layers of the full-width model, as kernels-line keys."""
    by_d = kernel_wrappers()[key].launches_by_d
    return {f"{key}_d{d}": by_d[d] for d in (6, 4)}


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def entry_point_counts(label: str, need) -> dict:
    """The launch counts of one entry point's ``main``, read right after it
    (they were set to 0 just before): every kernel of ``need`` must have
    launched there, and B6 and B11, which no entry point of 10d and 10e
    reaches, must not."""
    ran = read_counts()
    log(f"[10] launches in {label}: {ran}")
    if min(ran[k] for k in need) == 0 or ran["b6"] or ran["b11"]:
        raise AssertionError(f"{label}: launches {ran}; {need} must be above 0, B6 and B11 "
                             f"at 0 (B11 stands beside the model)")
    return ran


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA required (torch.cuda.is_available() "
                         "is False); the port has no CPU fallback for this run")
    sys.path.insert(0, HERE)
    from nbody_tpu_torch.ops import build  # fails when run alone

    card = card_line()
    log(f"[0] card: {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on"
    t0 = time.perf_counter()
    build.load_all(SOURCES)  # one nvcc per source, all at once
    log(f"[0] kernels built in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        info = build.BUILD_INFO[name]
        log(f"[0] {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[0]   ptxas: {line.strip()}")
    return card


def phase0b_prng(card: str) -> None:
    """``utils.prng`` on the card: JAX's known answers; 100,000 draws of
    each kind (split, bits, uniform, normal, gamma(2), choice) the CPU's bits;
    the 100,000-body spiral of seed 1042 drawn on the card against the CPU's
    (positions within rtol 1e-5 and 1e-6 of max |x|, velocities 1e-4 of
    max |v|, masses equal: the galaxy takes its functions through float64,
    so the two differ only where a double rounding does); the wall time of
    a 10,000,000-body spiral drawn on the card, twice."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng

    cuda = torch.device("cuda")
    miss = known_answer_mismatches(cuda)
    if miss:
        raise AssertionError(f"prng known answers missed on the card: {miss}")
    log(f"[0b] prng known answers on the card: all {len(KNOWN_ANSWERS)} equal "
        f"(threefry (0, 0), split, bits, choice, uniform, normal, gamma)")
    k, n = prng.PRNGKey(1042), 100_000
    draws = {"split": lambda d: prng.split(k, n, d),
             "bits": lambda d: prng.random_bits(k, n, d),
             "uniform": lambda d: prng.uniform(k, n, -1.0, 1.0, d),
             "normal": lambda d: prng.normal(k, n, d),
             "gamma": lambda d: prng.gamma(k, 2.0, n, d),
             "choice": lambda d: prng.choice(k, n, (4096,), device=d)}
    for name, draw in draws.items():
        got, want = draw(cuda).cpu(), draw("cpu")
        unequal = int((got != want).sum())
        log(f"[0b] {name} x {want.numel()}: card vs CPU, {unequal} unequal")
        if unequal:
            raise AssertionError(f"prng {name}: the card's draws differ from the CPU's")
    got = [t.cpu() for t in generate_spiral(k, n, device=cuda)]
    want = generate_spiral(k, n, device="cpu")
    for name, g, w, frac in zip(("positions", "velocities", "masses"), got, want,
                                (1e-6, 1e-4, 0.0)):
        atol = frac * float(w.abs().max())
        d = (g - w).abs()
        log(f"[0b] spiral {n} (seed 1042) {name}: card vs CPU max |d| {float(d.max()):.3e}, "
            f"{float((d > 0).float().mean()):.4f} unequal (rtol 1e-5, atol {atol:.3e})")
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol)
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, vel, mass = generate_spiral(prng.PRNGKey(0), 10_000_000, device=cuda)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not all(bool(torch.isfinite(t).all()) for t in (pos, vel, mass)):
            raise AssertionError("the 10M spiral is not finite")
        log(f"[0b] 10,000,000-body spiral (seed 0) drawn on the card in {secs:.3f} s "
            f"(draw {rep + 1}; {card})")
    del pos, vel, mass
    torch.cuda.empty_cache()


def init_card_vs_cpu(cuda) -> dict:
    """Flax's streams (``models/init.py``) on the card against the CPU:
    both reference configurations' models drawn from ``PRNGKey(0)``'s init
    key ``split(PRNGKey(0))[1]`` on ``cuda`` and on the CPU (values and
    unequal ones), the wall seconds of each card draw, and one step's
    dropout mask: the first step key of a seed-0 trainer's first bucket on
    a recipe GNN batch (64 x 500 bodies x 64 features, rate 0.1), on the
    card whole and as the second of two ranks' rows, against the CPU's."""
    import torch

    from nbody_tpu_torch.models.mlp import Dropout, set_dropout_key
    from nbody_tpu_torch.utils import prng

    out = {}
    key = prng.split(prng.PRNGKey(0))[1]
    card_models = {k: m.to(cuda) for k, m in _reference_models().items()}
    for name, cpu_model in _reference_models().items():
        model = card_models[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.draw_weights(key.to(cuda))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cpu_model.draw_weights(key)
        want = cpu_model.state_dict()
        got = {k: v.cpu() for k, v in model.state_dict().items()}
        out[name] = {"values": sum(v.numel() for v in want.values()),
                     "unequal": sum(int((got[k] != v).sum()) for k, v in want.items()),
                     "draw_s": secs}
    rng = prng.split(prng.PRNGKey(0))[0]  # a seed-0 trainer's key after its init split
    sub = prng.split(rng)[1]               # its first bucket's
    step = prng.split(sub, 188)[0]         # the bucket's first step key
    x = prng.normal(prng.PRNGKey(7), (64, 500, 64))
    layer = Dropout(0.1, ("MLP_0", "Dropout_0")).train()
    set_dropout_key(layer, step)
    want = layer(x)
    set_dropout_key(layer, step.to(cuda))
    got = layer(x.to(cuda)).cpu()
    set_dropout_key(layer, step.to(cuda), rows=(32, 64))
    rows = layer(x[32:].to(cuda)).cpu()
    out["dropout"] = {"values": want.numel(), "kept": float((want != 0).float().mean()),
                      "unequal": int((got != want).sum()),
                      "rows_unequal": int((rows != want[32:]).sum())}
    return out


def phase0c_flax_init(card: str) -> None:
    """``models/init.py`` on the card: JAX's initial models' known answers
    drawn there, both reference models and one step's dropout mask the
    CPU's bits (:func:`init_card_vs_cpu`)."""
    import torch

    cuda = torch.device("cuda")
    miss = init_known_answer_mismatches(cuda)
    if miss:
        raise AssertionError(f"initial-model known answers missed on the card: {miss}")
    log(f"[0c] initial-model known answers on the card: all {len(INIT_KNOWN_ANSWERS)} "
        f"equal (JAX's jit(model.init) values)")
    res = init_card_vs_cpu(cuda)
    for name in ("gnn", "contconv"):
        r = res[name]
        log(f"[0c] {name} reference model from split(PRNGKey(0))[1]: {r['values']} values "
            f"drawn on the card in {r['draw_s']:.3f} s, {r['unequal']} unequal to the "
            f"CPU's ({card})")
    d = res["dropout"]
    log(f"[0c] dropout mask of one step (64 x 500 x 64, rate 0.1): {d['values']} values, "
        f"kept share {d['kept']:.5f}, card vs CPU {d['unequal']} unequal, a rank's rows "
        f"{d['rows_unequal']} unequal")
    if res["gnn"]["unequal"] or res["contconv"]["unequal"] or d["unequal"] \
            or d["rows_unequal"]:
        raise AssertionError(f"flax draws on the card differ from the CPU's: {res}")


def phase1_kernels():
    """Each kernel against its twin; returns the 20k-shape numbers."""
    import torch

    from nbody_tpu_torch.core import SimulationConfig, simulate
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.utils.timing import cuda_time_ms, kernel_events

    dev = torch.device("cuda")
    results = {}
    for n in (500, 1_000, BIG_N):
        pos, _, mass = generate_spiral(prng.PRNGKey(n), n, device=dev)
        acc_k = pw.partial_accelerations(pos, pos, mass, G, EPS)
        acc_t = pw.partial_accelerations_torch(pos, pos, mass, G, EPS)
        d_acc = float((acc_k - acc_t).abs().max())
        rel_acc = d_acc / float(acc_t.abs().max())
        ms_k = cuda_time_ms(lambda: pw.partial_accelerations(pos, pos, mass, G, EPS))
        ms_t = cuda_time_ms(lambda: pw.partial_accelerations_torch(pos, pos, mass, G, EPS),
                            reps=5, warmup=1)
        log(f"[1] B1 force    N={n}: max|da|/max|a| {rel_acc:.3e} (bar {B1_TOL}) "
            f"kernel {ms_k:.4f} ms  twin {ms_t:.4f} ms")
        if not rel_acc <= B1_TOL:
            raise AssertionError(f"B1 disagrees with its twin at N={n}: {rel_acc}")

        u_k = pw.pair_potential(pos, mass, pos, mass, G, EPS, masked=True)
        u_t = pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, masked=True)
        d_u = abs(float(u_k) - float(u_t))
        rel_u = d_u / abs(float(u_t))
        ms_uk = cuda_time_ms(lambda: pw.pair_potential(pos, mass, pos, mass, G, EPS, True))
        ms_ut = cuda_time_ms(lambda: pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, True),
                             reps=5, warmup=1)
        # device time a call (at N = 500 the host's share of ms_uk is most
        # of it) and kernels a call, from 20 calls under the profiler, read
        # once more if it saw another count than one kernel a call
        def b2_call():
            return pw.pair_potential(pos, mass, pos, mass, G, EPS, True)

        events = kernel_events(b2_call, reps=20)
        if len(events) != 20:
            log(f"[1] B2 N={n}: the profiler saw {len(events)} kernels in 20 calls; again")
            events = kernel_events(b2_call, reps=20)
        names = sorted({name for name, _ in events})
        dev_uk = sum(ms for _, ms in events) / max(len(events), 1)
        bnd_u = bound(*pw.energy_work(n, n, True))
        log(f"[1] B2 energy   N={n}: U kernel {float(u_k):.9e} twin {float(u_t):.9e} "
            f"rel {rel_u:.3e} (bar {B2_TOL}) kernel {ms_uk:.4f} ms a call, {dev_uk:.4f} ms "
            f"on the device in {len(events) / 20:g} kernel(s)  twin {ms_ut:.4f} ms  bound "
            f"{bnd_u[0]:.6f} ms ({bnd_u[1]})")
        one_kernel = len(events) == 20 and all("energy_kernel" in x for x in names)
        if not (rel_u <= B2_TOL and one_kernel):
            raise AssertionError(f"B2 (masked) at N={n}: against its twin {rel_u}, "
                                 f"{len(events)} kernels in 20 calls {names}")
        results[n] = dict(b1=(d_acc, ms_k, ms_t, bound(*pw.force_work(n, n))),
                          b2=(d_u, ms_uk, ms_ut, bnd_u))

    pos, _, mass = generate_spiral(prng.PRNGKey(8), 8_000, device=dev)
    a, ma, b, mb = pos[:3_000], mass[:3_000], pos[3_000:], mass[3_000:]
    a, b = a.contiguous(), b.contiguous()
    x_k = pw.pair_potential(a, ma, b, mb, G, EPS, masked=False)
    x_t = pw.pair_potential_torch(a, ma, b, mb, G, EPS, masked=False)
    rel_x = abs(float(x_k) - float(x_t)) / abs(float(x_t))
    ms_xk = cuda_time_ms(lambda: pw.pair_potential(a, ma, b, mb, G, EPS, False))
    ms_xt = cuda_time_ms(lambda: pw.pair_potential_torch(a, ma, b, mb, G, EPS, False),
                         reps=5, warmup=1)
    log(f"[1] B2 cross 3000x5000: rel {rel_x:.3e} (bar {B2_TOL}) "
        f"kernel {ms_xk:.4f} ms  twin {ms_xt:.4f} ms")
    if not rel_x <= B2_TOL:
        raise AssertionError(f"B2 (cross) disagrees with its twin: {rel_x}")
    # the kernel backend against the dense torch path on the card
    pos, vel, mass = generate_spiral(prng.PRNGKey(3), 256,
                                     device=torch.device("cuda"))
    cfg = dict(g_const=G, softening=EPS, dt=DT, calc_energy=True)
    tk = simulate(pos, vel, mass, 100, SimulationConfig(**cfg, force_backend="kernel"))
    td = simulate(pos, vel, mass, 100, SimulationConfig(**cfg, force_backend="dense"))
    d_pos = float((tk.positions - td.positions).abs().max())
    d_u = float(((tk.u_energy - td.u_energy) / td.u_energy).abs().max())
    log(f"[1] simulate N=256 x100 kernel vs dense: max|dpos| {d_pos:.3e} rel dU {d_u:.3e}")
    if not (d_pos <= 1e-5 and d_u <= 1e-5):
        raise AssertionError("kernel and dense simulate disagree on the card")

    torch.cuda.synchronize()
    return results[BIG_N]


def phase2_datagen(out_dir: str):
    import numpy as np
    import pandas as pd

    from nbody_tpu_torch.cli import datagen
    from nbody_tpu_torch.data.schema import CSV_FIELDS
    from nbody_tpu_torch.ops import pairwise as pw

    csv = os.path.join(out_dir, "recipe.csv")
    b1_0, b2_0 = pw.partial_accelerations.launches, pw.pair_potential.launches
    t0 = time.perf_counter()
    datagen.main([
        "--n-bodies", *map(str, RECIPE_N), "--sim-type", "spiral",
        "--steps", str(RECIPE_STEPS), "--dt", str(DT), "--softening", str(EPS),
        "--g", str(G), "--seed", "42", "--force-backend", "kernel",
        "--device", "cuda", "--output", csv])
    wall = time.perf_counter() - t0
    b1 = pw.partial_accelerations.launches - b1_0
    b2 = pw.pair_potential.launches - b2_0
    total_steps = len(RECIPE_N) * RECIPE_STEPS
    log(f"[2] datagen: {wall:.2f} s wall for {len(RECIPE_N)} scenes x "
        f"{RECIPE_STEPS} steps (CSV and npz writing included); "
        f"B1 launches {b1}, B2 launches {b2}")
    if b1 < total_steps or b2 < total_steps:
        raise AssertionError(f"datagen bypassed the kernels: B1 {b1}, B2 {b2}, "
                             f"steps {total_steps}")
    npz_path = csv[:-4] + ".npz"
    if not (os.path.exists(csv) and os.path.exists(npz_path)):
        raise AssertionError("datagen wrote no CSV or npz")
    df = pd.read_csv(csv)
    if list(df.columns) != CSV_FIELDS or len(df) != sum(RECIPE_N) * RECIPE_STEPS:
        raise AssertionError(f"bad CSV: columns {list(df.columns)}, rows {len(df)}")
    if not np.isfinite(df.drop(columns=["scene_type"]).to_numpy(np.float64)).all():
        raise AssertionError("non-finite values in the CSV")
    data = np.load(npz_path)
    for s, n in enumerate(RECIPE_N):
        step_ms = 1e3 * float(data[f"scene{s}_meta"][3])
        log(f"[2] scene {s} N={n}: {step_ms:.4f} ms/step, energy drift "
            f"{rel_drift(data[f'scene{s}_u'], data[f'scene{s}_k']):.3e}")
    drift = rel_drift(data["scene5_u"], data["scene5_k"])
    if not drift < DRIFT_500:
        raise AssertionError(f"500-body energy drift {drift} >= {DRIFT_500}")


def recipe_scenes(n: int, seeds, steps: int):
    """Spiral scenes of ``n`` bodies with the reference recipe's parameters
    (``configs/gnn_reference.json``), one a seed, through the kernels."""
    from nbody_tpu_torch.data.generate import ScenarioConfig

    with open(os.path.join(HERE, "configs", "gnn_reference.json")) as f:
        dg = json.load(f)["datagen"]
    keep = {k: v for k, v in dg.items()
            if k not in ("n_bodies", "steps", "seed", "train_files", "test_files")}
    return [ScenarioConfig(n_bodies=n, steps=steps, seed=s, force_backend="kernel", **keep)
            for s in seeds]


def _stacked_ics(scenes):
    """A group's stacked initial (pos, vel, mass) on the card, each scene's
    from its own generator, as ``run_scenario_group`` makes them."""
    import torch

    from nbody_tpu_torch.data.generate import make_initial_conditions

    ics = [make_initial_conditions(c, device=torch.device("cuda")) for c in scenes]
    return tuple(torch.stack([x[f] for x in ics]) for f in range(3))


def grouped_kernel_numbers(pos, mass, label: str) -> dict:
    """B1 and B2 on a group (one launch each) against their batched plain
    versions and against one call a scene (the same bits), with times by
    CUDA events and the bound of S x the single-scene work."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    s, n = mass.shape
    out = {}
    for key, kernel, plain, single, work, tol in (
            ("b1g", lambda: pw.partial_accelerations(pos, pos, mass, G, EPS),
             lambda: pw.partial_accelerations_torch(pos, pos, mass, G, EPS),
             lambda i: pw.partial_accelerations(pos[i], pos[i], mass[i], G, EPS),
             pw.force_work(n, n), B1_TOL),
            ("b2g", lambda: pw.pair_potential(pos, mass, pos, mass, G, EPS, True),
             lambda: pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, True),
             lambda i: pw.pair_potential(pos[i], mass[i], pos[i], mass[i], G, EPS, True),
             pw.energy_work(n, n, True), B2_TOL)):
        got, want = kernel(), plain()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max()) if key == "b1g" else float(
            ((got.double() - want.double()).abs() / want.double().abs()).max())
        same = all(torch.equal(got[i], single(i)) for i in range(s))
        ms = cuda_time_ms(kernel)
        ms_single = cuda_time_ms(lambda: [single(i) for i in range(s)])
        ms_plain = cuda_time_ms(plain, reps=3, warmup=1)
        bnd = bound(*(s * w for w in work))
        log(f"[{label}] {key.upper()[:2]} grouped {s} x {n}: one launch {ms:.4f} ms, {s} "
            f"single-scene calls {ms_single:.4f} ms, plain {ms_plain:.4f} ms, bound "
            f"{bnd[0]:.6f} ms ({bnd[1]}); against the plain version {rel:.3e} (bar {tol}); "
            f"each scene the bits of its own call: {same}")
        if not (rel <= tol and same):
            raise AssertionError(f"grouped {key} at {s} x {n}: {rel}, same bits {same}")
        out[key] = (err, ms, ms_plain, bnd)
    return out


def phase2b_grouped_datagen(out_dir: str):
    """Grouped datagen at the recipe width: 8 spiral scenes of 500 bodies
    that differ only by seed, 1000 leapfrog steps, through
    ``generate_dataset`` (scene groups on by default), then the same list
    one scene at a time, both writing only the npz. Then the native CSV
    writer on a shorter grouped run of the same scenes. Returns B1's and
    B2's launches of the grouped run, read right after it (the counters were
    set to 0 just before), and the kernels-line numbers of the grouped B1
    and B2 at its shape."""
    import numpy as np
    import pandas as pd
    import torch

    from nbody_tpu_torch.core import SimulationConfig, Trajectory, simulate
    from nbody_tpu_torch.data import io_native
    from nbody_tpu_torch.data.generate import generate_dataset, trajectory_to_rows
    from nbody_tpu_torch.data.schema import CSV_FIELDS
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.utils.timing import device_time, kernel_events

    scenes = recipe_scenes(RECIPE_N[-1], GROUP_SEEDS, RECIPE_STEPS)
    s, steps = len(scenes), RECIPE_STEPS
    grouped, alone = (os.path.join(out_dir, f"{name}.csv") for name in ("grouped", "alone"))
    t0 = time.perf_counter()
    generate_dataset(scenes, grouped, verbose=False, write_csv_file=False, device="cuda")
    wall_g = time.perf_counter() - t0
    counts = {"b1g": pw.partial_accelerations.launches, "b2g": pw.pair_potential.launches}
    t0 = time.perf_counter()
    generate_dataset(scenes, alone, verbose=False, vmap_scenes=False, write_csv_file=False,
                     device="cuda")
    wall_a = time.perf_counter() - t0
    b1_a = pw.partial_accelerations.launches - counts["b1g"]
    b2_a = pw.pair_potential.launches - counts["b2g"]
    zg, za = np.load(grouped[:-4] + ".npz"), np.load(alone[:-4] + ".npz")
    ms_g = 1e3 * float(zg["scene0_meta"][3])
    ms_a = [1e3 * float(za[f"scene{i}_meta"][3]) for i in range(s)]
    log(f"[2b] grouped datagen, {s} x {scenes[0].n_bodies} bodies x {steps} steps: {wall_g:.2f} "
        f"s wall (npz only), {ms_g:.4f} ms a step a scene; B1 {counts['b1g']}, "
        f"B2 {counts['b2g']} launches ({(counts['b1g'] + counts['b2g']) / steps:.3f} a step)")
    log(f"[2b] one scene at a time (npz only): {wall_a:.2f} s wall, ms a step a scene "
        f"{[round(x, 4) for x in ms_a]} (mean {np.mean(ms_a):.4f}); B1 {b1_a}, B2 {b2_a} "
        f"launches ({(b1_a + b2_a) / steps:.3f} a step)")
    if (counts != {"b1g": steps + 1, "b2g": steps}
            or (b1_a, b2_a) != (s * (steps + 1), s * steps)):
        raise AssertionError(f"B1 and B2 must launch once a step for the group: grouped "
                             f"{counts}, one at a time {b1_a}, {b2_a}")
    drifts = []
    for i in range(s):
        for f in ("pos", "vel", "acc", "u", "k", "mass"):
            if not np.array_equal(zg[f"scene{i}_{f}"], za[f"scene{i}_{f}"]):
                raise AssertionError(f"scene {i} {f}: grouped and alone differ")
        drifts.append(rel_drift(zg[f"scene{i}_u"], zg[f"scene{i}_k"]))
    log(f"[2b] each scene's trajectory and energies: the same bits grouped and alone; "
        f"energy drifts {[f'{d:.3e}' for d in drifts]} (bar {DRIFT_500})")
    if not max(drifts) < DRIFT_500:
        raise AssertionError(f"grouped 500-body drift {max(drifts)} >= {DRIFT_500}")

    # the CSV, on the same scenes cut to CSV_STEPS steps: the native
    # writer's, and the same bytes as every scene's rows, rebuilt from the
    # npz twin, written again through io_native
    if not io_native.native_available():
        raise AssertionError("the native CSV writer did not build or load on this machine")
    short = recipe_scenes(RECIPE_N[-1], GROUP_SEEDS, CSV_STEPS)
    csv, again = (os.path.join(out_dir, f"{name}.csv") for name in ("short", "again"))
    t0 = time.perf_counter()
    generate_dataset(short, csv, verbose=False, device="cuda")
    wall_csv = time.perf_counter() - t0
    zs = np.load(csv[:-4] + ".npz")
    t0 = time.perf_counter()
    io_native.write_csv(pd.concat([pd.DataFrame(trajectory_to_rows(
        i, c, Trajectory(*(zs[f"scene{i}_{f}"] for f in ("pos", "vel", "acc", "u", "k"))),
        zs[f"scene{i}_mass"], float(zs[f"scene{i}_meta"][3])))
        for i, c in enumerate(short)], ignore_index=True)[CSV_FIELDS], again)
    write_s = time.perf_counter() - t0
    with open(csv, "rb") as f, open(again, "rb") as g:
        body = f.read()
        same = body == g.read()
    rows = body.count(b"\n") - 1
    log(f"[2b] grouped datagen with its CSV, {s} x {short[0].n_bodies} bodies x {CSV_STEPS} "
        f"steps: {wall_csv:.2f} s wall; CSV {rows} rows, {len(body)} bytes, native writer; "
        f"every scene's rows written again from the npz twin in {write_s:.2f} s, the same "
        f"bytes: {same}")
    if rows != s * CSV_STEPS * short[0].n_bodies or not same:
        raise AssertionError("the grouped dataset's CSV is not the native writer's bytes")

    # 20 grouped steps under the profiler: kernels and device time a step
    pos, vel, mass = _stacked_ics(scenes)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, calc_energy=True,
                           force_backend="kernel")

    def run():
        return simulate(pos, vel, mass, 20, cfg)

    run()
    _, wall = device_time(run, "cuda")
    events = kernel_events(run, reps=1)
    busy = sum(ms for _, ms in events)
    log(f"[2b] {s} x {scenes[0].n_bodies}, 20 grouped steps under the profiler: "
        f"{len(events) / 20:.1f} kernels a step, {1e3 * wall / 20:.4f} ms/step wall "
        f"({1e3 * wall / 20 / s:.4f} a scene), {busy / 20:.4f} on the device (idle share "
        f"{1 - busy / (1e3 * wall):.3f})")
    torch.cuda.synchronize()
    return counts, grouped_kernel_numbers(pos, mass, "2b")


def phase2c_real_size():
    """4 scenes of 20,000 bodies for 200 steps as one group against the same
    4 one by one (``run_scenario_group`` / ``run_scenario``): the same bits,
    drift under the 20k bar, and B1's and B2's grouped times."""
    import torch

    from nbody_tpu_torch.data.generate import run_scenario, run_scenario_group

    scenes = recipe_scenes(BIG_N, range(BIG_GROUP), BIG_STEPS)
    t0 = time.perf_counter()
    group = run_scenario_group(scenes, device="cuda")
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = [run_scenario(c, device="cuda") for c in scenes]
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    drifts = []
    for i, ((tg, mg, _), (ta, ma, _)) in enumerate(zip(group, alone)):
        if not (all(torch.equal(a, b) for a, b in zip(tg, ta)) and (mg == ma).all()):
            raise AssertionError(f"20k scene {i}: grouped and alone differ")
        drifts.append(rel_drift(tg.u_energy.cpu(), tg.k_energy.cpu()))
    log(f"[2c] {BIG_GROUP} x {BIG_N} bodies x {BIG_STEPS} steps: grouped {wall_g:.2f} s wall, "
        f"{1e3 * group[0][2]:.4f} ms a step a scene; one by one {wall_a:.2f} s, "
        f"{[round(1e3 * a[2], 4) for a in alone]} ms a step; the same bits; drifts "
        f"{[f'{d:.3e}' for d in drifts]} (bar {DRIFT_20K})")
    if not max(drifts) < DRIFT_20K:
        raise AssertionError(f"grouped 20k drift {max(drifts)} >= {DRIFT_20K}")
    del group, alone
    pos, _, mass = _stacked_ics(scenes)
    grouped_kernel_numbers(pos, mass, "2c")


def energy_kernels_per_energy(n: int = RECIPE_N[-1], steps: int = 20):
    """The recipe's rollout with energies at ``n`` bodies, timed and under
    the profiler, after the main path's counts are read: B2 must be one
    kernel an energy (the profiler's count of ``energy_kernel`` events is
    the wrapper's count of energies, read once more if not), and no kernel
    of the step is one of the partials and reduce kernels it had before."""
    import torch

    from nbody_tpu_torch.core import SimulationConfig, simulate
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.utils.timing import device_time, kernel_events

    pos, vel, mass = generate_spiral(prng.PRNGKey(42), n,
                                     device=torch.device("cuda"))
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, calc_energy=True,
                           force_backend="kernel")

    def run():
        return simulate(pos, vel, mass, steps, cfg)

    simulate(pos, vel, mass, 2, cfg)
    _, wall = device_time(run, "cuda")
    before = pw.pair_potential.launches
    run()
    energies = pw.pair_potential.launches - before
    for _ in range(2):  # a second reading if the first counts otherwise
        events = kernel_events(run, reps=1)
        b2 = sum("energy_kernel" in name for name, _ in events)
        if b2 == energies:
            break
        log(f"[2] the profiler saw {b2} B2 kernels for {energies} energies; again")
    busy = sum(ms for _, ms in events)
    b2_ms = sum(ms for name, ms in events if "energy_kernel" in name)
    old_b2 = [name for name, _ in events
              if "energy_partials" in name or "::reduce_kernel(double" in name]
    log(f"[2] N={n} x {steps} steps under the profiler: {energies} energies, {b2} B2 "
        f"kernels, {len(events) / steps:.1f} kernels a step; {1e3 * wall / steps:.4f} ms/step "
        f"wall, {busy / steps:.4f} on the device (idle share {1 - busy / (1e3 * wall):.3f}), "
        f"B2 {b2_ms / steps:.4f}")
    if not (energies >= steps and b2 == energies and not old_b2):
        raise AssertionError(f"B2 is not one kernel an energy: {energies} energies, {b2} "
                             f"kernels")


def phase3_real_size():
    import torch

    from nbody_tpu_torch.data.generate import ScenarioConfig, run_scenario

    cfg = ScenarioConfig(n_bodies=BIG_N, sim_type="spiral", steps=BIG_STEPS,
                         dt=DT, softening=EPS, g=G, seed=7,
                         force_backend="kernel", calc_energy=True)
    traj, masses, step_time = run_scenario(cfg, device="cuda")
    for t in traj:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite 20k trajectory")
    drift = rel_drift(traj.u_energy.cpu(), traj.k_energy.cpu())
    log(f"[3] N={BIG_N} x {BIG_STEPS} steps (B1 + B2 every step): "
        f"{1e3 * step_time:.4f} ms/step, energy drift {drift:.3e}")
    if not drift < DRIFT_20K:
        raise AssertionError(f"20k energy drift {drift} >= {DRIFT_20K}")
    return traj, masses


def ground_truth_step_profile(traj, masses, steps: int = 20):
    """``steps`` more steps of phase 3's scene from its last state, timed
    and under the profiler, after the main path's counts are read: wall and
    device ms a step, the idle share, and B2's and B1's shares."""
    import torch

    from nbody_tpu_torch.core import SimulationConfig, simulate
    from nbody_tpu_torch.utils.timing import device_time, kernel_events

    pos, vel = traj.positions[-1].contiguous(), traj.velocities[-1].contiguous()
    mass = torch.as_tensor(masses, dtype=torch.float32, device=pos.device)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, calc_energy=True,
                           force_backend="kernel")

    def run():
        return simulate(pos, vel, mass, steps, cfg)

    _, wall = device_time(run, "cuda")
    events = kernel_events(run, reps=1)
    busy = sum(ms for _, ms in events)
    b2_ms = sum(ms for name, ms in events if "energy_kernel" in name)
    b1_ms = sum(ms for name, ms in events if "force_kernel" in name)
    log(f"[3] N={BIG_N}, {steps} more steps: {1e3 * wall / steps:.4f} ms/step wall, "
        f"{busy / steps:.4f} on the device (idle share {1 - busy / (1e3 * wall):.3f}), "
        f"B2 {b2_ms / steps:.4f} ms/step ({b2_ms / busy:.3f} of the device time), "
        f"B1 {b1_ms / steps:.4f}")


def phase4_surrogate(data_dir: str, traj):
    import numpy as np
    import torch

    from nbody_tpu_torch.data.generate import make_initial_conditions, ScenarioConfig
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import Trainer, autoregressive_rollout, predict_accelerations
    from nbody_tpu_torch.utils.timing import device_time
    from nbody_tpu_torch.utils import prng

    dev = torch.device("cuda")
    kw = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
              neighbors=10, scale_factor=1e6)
    model = GraphModel(**kw, key=prng.PRNGKey(0)).to(dev).eval()

    # the model on the card against the same weights on the CPU
    cpu_model = GraphModel(**kw).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pos, vel, mass = make_initial_conditions(
        ScenarioConfig(n_bodies=500, sim_type="spiral", seed=42))
    a_gpu = predict_accelerations(model, pos.to(dev), vel.to(dev), mass.to(dev)).cpu()
    a_cpu = predict_accelerations(cpu_model, pos, vel, mass)
    if not torch.allclose(a_gpu, a_cpu, rtol=1e-4, atol=1e-5):
        raise AssertionError("GraphModel on the card disagrees with the CPU")

    t0 = time.perf_counter()
    df_step, df_roll = Trainer(model, dt=DT).test_from_dir(
        data_dir, sim_steps=EVAL_STEPS, stepwise=True, rollout=True)
    wall = time.perf_counter() - t0
    if (list(df_step.columns) != ["loss", "step_time"]
            or list(df_step.index.names) != ["filename", "scene"]
            or len(df_step) != len(RECIPE_N)):
        raise AssertionError(f"bad stepwise frame:\n{df_step}")
    if (list(df_roll.columns) != ["pos_rmse", "vel_rmse", "acc_rmse", "step_time"]
            or list(df_roll.index.names) != ["filename", "scene", "step"]
            or len(df_roll) != len(RECIPE_N) * EVAL_STEPS):
        raise AssertionError(f"bad rollout frame:\n{df_roll}")
    for df in (df_step, df_roll):
        if not np.isfinite(df.to_numpy(np.float64)).all():
            raise AssertionError("non-finite evaluation metrics")
    log(f"[4] test_from_dir: {wall:.2f} s wall")
    log("[4] stepwise (mean per scene):\n" + df_step.to_string())
    per_scene = df_roll.groupby(level="scene").agg(
        pos_rmse_last=("pos_rmse", "last"), acc_rmse_mean=("acc_rmse", "mean"),
        step_time=("step_time", "first"))
    log(f"[4] rollout ({EVAL_STEPS} steps per scene):\n" + per_scene.to_string())
    for s, n in enumerate(RECIPE_N):
        log(f"[4] N={n}: stepwise {1e3 * df_step['step_time'].iloc[s]:.4f} ms/snapshot, "
            f"rollout {1e3 * per_scene['step_time'].iloc[s]:.4f} ms/step")

    pos0, vel0 = traj.positions[0].contiguous(), traj.velocities[0].contiguous()
    _, _, mass20k = make_initial_conditions(ScenarioConfig(
        n_bodies=BIG_N, sim_type="spiral", seed=7), device=dev)
    autoregressive_rollout(model, pos0, vel0, mass20k, 2, DT)  # warm-up
    (ps, vs, accs), sec = device_time(
        lambda: autoregressive_rollout(model, pos0, vel0, mass20k, SURR_STEPS, DT), dev)
    for t in (ps, vs, accs):
        if t.shape != (SURR_STEPS, BIG_N, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError("bad 20k surrogate rollout")
    log(f"[4] surrogate rollout N={BIG_N} x {SURR_STEPS} steps (chunked exact kNN): "
        f"{1e3 * sec / SURR_STEPS:.4f} ms/step")
    return 1e3 * sec / SURR_STEPS


def phase5_large_n_kernels():
    """B7, B8 and B3 against their twins on the card; the full-width
    ContConv model on the card against the CPU. Returns the numbers of the
    kernels line: B7/B8 at 100k bodies, k = 32, B3 at 100k, D = 6 and 4."""
    import torch

    from nbody_tpu_torch.experiments.knn_recall import recall_of
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.experiments.select_bench import merge_edge_rows
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import ContinuousConvModel
    from nbody_tpu_torch.models.contconv import conv_geometry
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops.knn import knn_neighbors
    from nbody_tpu_torch.ops.radius import radius_neighbors
    from nbody_tpu_torch.train import predict_accelerations
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    out = {}
    for n in (BIG_N, LARGE_N):
        pos, _, _ = generate_spiral(prng.PRNGKey(n + 5), n, device=dev)
        order = sp._curve_order(pos, None, 4)
        cand, qg = sp._candidates(pos, order, 256)
        for k, inc in ((8, False), (10, False), (32, True))[n == BIG_N:]:
            ids, d2 = sp.morton_select(cand, k, 256, inc)
            ids_t, d2_t = sp.morton_select_torch(cand, k, 256, inc)
            ok7 = torch.equal(ids, ids_t) and torch.allclose(d2, d2_t, rtol=1e-6, atol=0)
            err7 = float((d2 - d2_t).abs().max())
            ms7 = cuda_time_ms(lambda: sp.morton_select(cand, k, 256, inc))
            ms7t = cuda_time_ms(lambda: sp.morton_select_torch(cand, k, 256, inc),
                                reps=3, warmup=1)
            mc, md = sp._to_rows(qg, ids, d2, n)
            m_ids, m_d2 = sp.morton_merge(mc, md, k)
            t_ids, t_d2 = sp.morton_merge_torch(mc, md, k)
            ok8 = torch.equal(m_ids, t_ids) and torch.allclose(m_d2, t_d2, rtol=1e-6, atol=0)
            err8 = float((m_d2 - t_d2).abs().max())
            ms8 = cuda_time_ms(lambda: sp.morton_merge(mc, md, k))
            ms8t = cuda_time_ms(lambda: sp.morton_merge_torch(mc, md, k), reps=3, warmup=1)
            ms_all = cuda_time_ms(lambda: sp.knn_morton(pos, k, include_self=inc,
                                                        impl="kernel"), reps=5, warmup=1)
            log(f"[5] B7 select N={n} k={k} self={inc}: ids identical {ok7}, max|dd2| "
                f"{err7:.3e}; kernel {ms7:.4f} ms  twin {ms7t:.4f} ms")
            log(f"[5] B8 merge  N={n} k={k}: ids identical {ok8}, max|dd2| {err8:.3e}; "
                f"kernel {ms8:.4f} ms  twin {ms8t:.4f} ms; whole knn_morton(kernel) "
                f"{ms_all:.4f} ms")
            if not (ok7 and ok8):
                raise AssertionError(f"B7/B8 disagree with their twins at N={n}, k={k}")
            if n == BIG_N:
                got = sp.knn_morton(pos, k, include_self=inc, impl="kernel")
                cpu = sp.knn_morton(pos.cpu(), k, include_self=inc, impl="kernel")
                same = all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))
                rec = recall_of(*got, *knn_neighbors(pos, k, include_self=inc))
                log(f"[5] knn_morton(kernel) N={n} k={k}: card == CPU twins {same}, "
                    f"recall vs exact {rec:.5f} (bar {RECALL})")
                if not (same and rec >= RECALL):
                    raise AssertionError(f"Morton kNN at N={n}, k={k}: same {same}, "
                                         f"recall {rec}")
            if n == LARGE_N:
                bnd7, bnd8 = select_merge_bounds(cand, ids, mc, m_ids, k, 256)
                log(f"[5] B7, B8 N={n} k={k}: bounds {bnd7[0]:.4f} ms ({bnd7[1]}), "
                    f"{bnd8[0]:.4f} ms ({bnd8[1]})")
                if k == 32:
                    out["b7"] = (err7, ms7, ms7t, bnd7)
                    out["b8"] = (err8, ms8, ms8t, bnd8)

        # B3 on the geometry of this N's Morton radius graph
        idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
        geom = conv_geometry(pos[None], idx[None], valid[None], 1.0)
        feat = torch.randn(n, 128, generator=torch.Generator().manual_seed(n)).to(dev)
        fj = feat[idx.long()].contiguous()
        win = geom["window"][0].contiguous()
        for d in (6, 4):
            grid = (geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)
            gx, gy, gz = (grid[..., a].contiguous() for a in range(3))
            filters = torch.randn(d ** 3, 128, 128,
                                  generator=torch.Generator().manual_seed(d)).to(dev)
            args = (gx, gy, gz, win, fj, filters)
            # the pair plan that B3 and B4 share: ids, order and offsets
            plan = cck.pair_plan(gx, gy, gz, win, d=d)
            same_plan = all(torch.equal(a, b) for a, b in
                            zip(plan, cck.pair_plan_torch(gx, gy, gz, win, d=d)))
            ms_plan = cuda_time_ms(lambda: cck.pair_plan(gx, gy, gz, win, d=d), reps=5,
                                   warmup=1)
            log(f"[5] pair plan N={n} k=32 D={d}: {plan.cell_r.numel()} pairs, equal to its "
                f"plain version {same_plan}; {ms_plan:.4f} ms")
            del plan
            got = cck.contconv_collect(*args, d=d)
            same = torch.equal(got, cck.contconv_collect(*args, d=d))
            want = cck.contconv_collect_torch(*args, d=d)
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ms = cuda_time_ms(lambda: cck.contconv_collect(*args, d=d), reps=5, warmup=1)
            ms_t = cuda_time_ms(lambda: cck.contconv_collect_torch(*args, d=d),
                                reps=3, warmup=1)
            bnd = collect_bound(gx, gy, gz, win, 128, 128, d, 4.0 * n * 128)
            log(f"[5] B3 collect N={n} k=32 D={d} ci=co=128: max|d|/max|out| {rel:.3e} "
                f"(bar {B3_TOL}), same bits twice {same}; kernel {ms:.4f} ms  twin "
                f"{ms_t:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
            if not (rel <= B3_TOL and same and same_plan):
                raise AssertionError(f"B3 at N={n}, D={d}: against its twin {rel}, same bits "
                                     f"{same}, plan equal to its plain version {same_plan}")
            if n == LARGE_N:
                out[f"b3_d{d}"] = (err, ms, ms_t, bnd)
        del fj, geom

    # B8 on rows beyond B7's output: duplicates, rows with fewer than k
    # unique ids, sentinels in the column-mask column, infinite distances
    for w, k in ((128, 32), (32, 8)):
        mc, md = (t.to(dev) for t in merge_edge_rows(EDGE_ROWS, w, k, seed=w, inf=True))
        got, want = sp.morton_merge(mc, md, k), sp.morton_merge_torch(mc, md, k)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                            want[1].view(torch.int32))
        short = float((want[1] >= sp._BAD_D2).any(1).float().mean())
        log(f"[5] B8 merge on {EDGE_ROWS} edge rows, w={w} k={k} ({short:.3f} of them run "
            f"out of unique ids or pick a sentinel): ids and bits equal to its plain version "
            f"{same}")
        if not same:
            raise AssertionError(f"B8 disagrees with its plain version on edge rows, w={w}")

    # the full-width model: kernels on the card, twins on the CPU, same weights
    model = ContinuousConvModel(**FULL_CONTCONV, key=prng.PRNGKey(4)).eval()
    pos, vel, mass = generate_spiral(prng.PRNGKey(2), GRAD_N)
    a_cpu = predict_accelerations(model, pos, vel, mass)
    model.to(dev)
    before = cck.contconv_collect.launches
    a_gpu = predict_accelerations(model, pos.to(dev), vel.to(dev), mass.to(dev)).cpu()
    if cck.contconv_collect.launches != before + 2:
        raise AssertionError("the model's layers did not go through B3")
    scale = float(a_cpu.abs().max())
    d_model = float((a_gpu - a_cpu).abs().max())
    log(f"[5] ContinuousConvModel N=2000 card vs CPU: max|da| {d_model:.3e}, max|a| {scale:.3e}")
    if not torch.allclose(a_gpu, a_cpu, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
        raise AssertionError("the ContConv model on the card disagrees with the CPU")
    torch.cuda.synchronize()
    return out


def phase6_large_n_path(exact_20k_ms: float):
    """The large-N surrogate path through the port's large_scale entry point at
    100k bodies, both surrogate families; then the 20k GNN rollout with
    Morton kNN beside phase 4's exact-kNN one."""
    import torch

    from nbody_tpu_torch.experiments import large_scale
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import autoregressive_rollout
    from nbody_tpu_torch.utils.timing import device_time

    base = ["--n-bodies", str(LARGE_N), "--steps", str(LARGE_STEPS), "--device", "cuda",
            "--modes", "direct", "surrogate", "hybrid"]
    runs = {"contconv": ["--model", "contconv", "--conv-impl", "kernel", "--knn-impl", "kernel"],
            "gnn-morton": ["--model", "gnn", "--knn-method", "morton", "--knn-impl", "kernel"]}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        res = large_scale.main(base + argv)
        wall = time.perf_counter() - t0
        if set(res) != {"direct", "surrogate", "hybrid"}:
            raise AssertionError(f"{name}: modes {sorted(res)}")
        for mode, r in res.items():
            vals = [r["seconds"], r["psteps_per_s"]]
            if mode == "surrogate":
                vals.append(r["final_pos_rmse_vs_direct"])
            if not all(math.isfinite(v) and v >= 0 for v in vals):
                raise AssertionError(f"{name} {mode}: non-finite result {r}")
            log(f"[6] {name} {mode} N={LARGE_N}: {1e3 * r['seconds'] / LARGE_STEPS:.4f} "
                f"ms/step" + (f", final pos RMSE vs direct {r['final_pos_rmse_vs_direct']:.3e}"
                              if mode == "surrogate" else ""))
        log(f"[6] {name}: {wall:.2f} s wall with warm-ups")

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(prng.PRNGKey(7), BIG_N, device=dev)
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=10, scale_factor=1e6, knn_method="morton",
                       knn_impl="kernel", key=prng.PRNGKey(0)).to(dev).eval()
    autoregressive_rollout(model, pos, vel, mass, 2, DT)
    (ps, _, _), sec = device_time(
        lambda: autoregressive_rollout(model, pos, vel, mass, SURR_STEPS, DT), dev)
    if not bool(torch.isfinite(ps).all()):
        raise AssertionError("bad 20k Morton surrogate rollout")
    log(f"[6] GNN surrogate rollout N={BIG_N}: Morton kNN (kernels) "
        f"{1e3 * sec / SURR_STEPS:.4f} ms/step; chunked exact kNN (phase 4) "
        f"{exact_20k_ms:.4f} ms/step")


def _bwd_against_plain(args, dout, d: int, label: str, time_it: bool) -> dict:
    """B4, B5 and B6 on one shape against the plain backward, each twice
    for the same bits; {"b4"|"b5"|"b6": (max abs err, ms, plain ms)}."""
    import torch

    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    want = cck.contconv_collect_bwd_torch(*args, dout, d=d)
    parts = {"b4": (cck.contconv_bwd_filters, (5,)), "b5": (cck.contconv_bwd_feat, (4,)),
             "b6": (cck.contconv_bwd_geom, (0, 1, 2, 3))}
    out = {}
    for key, (fn, slots) in parts.items():
        def call(fn=fn):
            got = fn(*args, dout, d=d)
            return got if isinstance(got, tuple) else (got,)

        got, again = call(), call()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = [float((g - want[s]).abs().max()) for g, s in zip(got, slots)]
        rel = max(e / max(float(want[s].abs().max()), 1e-30) for e, s in zip(errs, slots))
        ms = plain_ms = float("nan")
        if time_it:
            need = tuple(i in slots for i in range(6))
            ms = cuda_time_ms(call, reps=3, warmup=1)
            plain_ms = cuda_time_ms(
                lambda: cck.contconv_collect_bwd_torch(*args, dout, d=d, need=need),
                reps=2, warmup=1)
        log(f"[7] {key.upper()} {fn.__name__} {label}: max|d|/max|plain| {rel:.3e} "
            f"(bar {B3_TOL}), same bits twice {same}; kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms")
        if not (rel <= B3_TOL and same):
            raise AssertionError(f"{key} disagrees with its plain version ({label}): "
                                 f"{rel}, same bits {same}")
        out[key] = (max(errs), ms, plain_ms)
    return out


def _b5_passes_against_plain(args, dout, d: int) -> None:
    """B5's dG product and unbin pass, each against its plain version on
    the same plan (max |d| / max |plain| within B3_TOL)."""
    import torch

    from nbody_tpu_torch.ops import contconv_kernel as cck

    gx, gy, gz, win, _, filters = args
    ci, co = filters.shape[1], filters.shape[2]
    plan, items = cck._plan_cuda(gx, gy, gz, win, d)
    dg = cck._product_cuda(cck._padded_rows(dout), True, cck._f_transposed(filters), plan,
                           items, co, ci, d)
    want_dg = cck.pair_dg_torch(plan, dout, filters)
    dfeat = cck._unbins_cuda(plan, dg, gx, gy, gz, win, d, torch.empty_like(args[4]))
    want = cck.pair_unbins_torch(plan, dg[:, :ci], gx, gy, gz, win, d=d)
    rels = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in ((dg[:, :ci], want_dg), (dfeat, want))]
    log(f"[7] B5 passes on the small shape: dG {rels[0]:.3e}, unbins {rels[1]:.3e} of max "
        f"|plain| (bar {B3_TOL}); dG pad columns zero {not dg[:, ci:].any()}")
    if not (max(rels) <= B3_TOL and not dg[:, ci:].any()):
        raise AssertionError(f"B5's passes disagree with their plain versions: {rels}")


def _b6_pass_against_plain(args, dout, d: int, label: str) -> None:
    """B6's geometry pass against its pair-wise plain version
    (``pair_geom_torch``) on one plan that keeps the edges of zero window and
    one dG buffer, twice for the same bits (max |d| / max |plain| within
    B3_TOL)."""
    import torch

    from nbody_tpu_torch.ops import contconv_kernel as cck

    gx, gy, gz, win, fj, filters = args
    ci, co = filters.shape[1], filters.shape[2]
    plan, items = cck._plan_cuda(gx, gy, gz, win, d, all_edges=True)
    dg = cck._product_cuda(cck._padded_rows(dout), True, cck._f_transposed(filters), plan,
                           items, co, ci, d)
    got = cck._geom_cuda(plan, dg, gx, gy, gz, win, fj, d)
    same = all(torch.equal(a, b) for a, b in
               zip(got, cck._geom_cuda(plan, dg, gx, gy, gz, win, fj, d)))
    want = cck.pair_geom_torch(plan, dg[:, :ci], gx, gy, gz, win, fj, d=d)
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(got, want))
    dead = win == 0
    log(f"[7] B6 geometry pass {label}: {plan.cell_r.numel()} pairs with the "
        f"{int(dead.sum())} edges of zero window kept; max|d|/max|plain| {rel:.3e} (bar "
        f"{B3_TOL}), same bits twice {same}; dead edges' dwindow nonzero "
        f"{bool((got[3][dead] != 0).any()) if bool(dead.any()) else 'n/a'}")
    if not (rel <= B3_TOL and same):
        raise AssertionError(f"B6's pass disagrees with its plain version ({label}): {rel}, "
                             f"same bits {same}")


def _b6_device_ms(args, dout, d: int, reps: int = 5):
    """B6's device ms a call: every kernel of the wrapper (plan, dG product,
    geometry pass) and the geometry pass alone, from the profiler."""
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.utils.timing import kernel_events

    events = kernel_events(lambda: cck.contconv_bwd_geom(*args, dout, d=d), reps=reps)
    geom = [t for n, t in events if "bwd_geom" in n]
    return sum(t for _, t in events) / reps, sum(geom) / max(len(geom), 1)


def phase7_backward_kernels():
    """B4-B6 against the plain backward; returns the kernels line's numbers
    (100k; B4 and B5 at D = 6 and 4, B6 at D = 6)."""
    import torch

    from nbody_tpu_torch.experiments.contconv_bench import b6_bound_ms
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models.contconv import conv_geometry
    from nbody_tpu_torch.ops.radius import radius_neighbors

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    m, k, ci, co, d = 333, 7, 5, 3, 3  # a small odd shape, some edges clamped
    g3 = [(torch.rand(m, k, generator=gen) * (d + 0.4) - 0.3).to(dev) for _ in range(3)]
    win = (torch.rand(m, k, generator=gen) * (torch.rand(m, k, generator=gen) > 0.2)).to(dev)
    args = (*g3, win, torch.randn(m, k, ci, generator=gen).to(dev),
            torch.randn(d ** 3, ci, co, generator=gen).to(dev))
    dout = torch.randn(m, co, generator=gen).to(dev)
    _bwd_against_plain(args, dout, d, f"M={m} k={k} ci={ci} co={co} D={d}", time_it=False)
    _b5_passes_against_plain(args, dout, d)
    _b6_pass_against_plain(args, dout, d, f"M={m} k={k} ci={ci} co={co} D={d}")
    # zero windows, coordinates clamped and on the integer grid, a dead receiver
    g3 = [t.clone() for t in g3]
    for t in g3:
        on_grid = (torch.rand(m, k, generator=gen) < 0.3).to(dev)
        t[on_grid] = torch.randint(-1, d + 1, (int(on_grid.sum()),), generator=gen).float().to(dev)
    win = win.clone()
    win[m // 2] = 0.0
    edge_args = (*g3, win, *args[4:])
    _bwd_against_plain(edge_args, dout, d, "on grid, clamped and zero-window edges",
                       time_it=False)
    _b6_pass_against_plain(edge_args, dout, d, "on grid, clamped and zero-window edges")

    pos, _, _ = generate_spiral(prng.PRNGKey(LARGE_N + 5), LARGE_N,
                                device=dev)
    idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
    geom = conv_geometry(pos[None], idx[None], valid[None], 1.0)
    fj = torch.randn(LARGE_N, 128, generator=gen).to(dev)[idx.long()].contiguous()
    win = geom["window"][0].contiguous()
    dout = torch.randn(LARGE_N, 128, generator=gen).to(dev)
    out = {}
    for d in (6, 4):
        grid = (geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)
        args = (*(grid[..., a].contiguous() for a in range(3)), win, fj,
                torch.randn(d ** 3, 128, 128, generator=gen).to(dev))
        res = _bwd_against_plain(args, dout, d, f"N={LARGE_N} k=32 ci=co=128 D={d}",
                                 time_it=True)
        _b6_pass_against_plain(args, dout, d, f"N={LARGE_N} k=32 ci=co=128 D={d}")
        dev_all, dev_pass = _b6_device_ms(args, dout, d)
        log(f"[7] B6 N={LARGE_N} D={d}: {dev_all:.4f} device ms a call (plan, dG product, "
            f"geometry pass), {dev_pass:.4f} of them the geometry pass")
        for key, nums in res.items():  # other operands: dout (M, co)
            bnd = (b6_bound_ms(args[:3], args[3], 128, 128, d) if key == "b6" else
                   collect_bound(*args[:4], 128, 128, d, 4.0 * LARGE_N * 128))
            log(f"[7] {key.upper()} D={d}: bound {bnd[0]:.4f} ms ({bnd[1]})")
            if key in ("b4", "b5"):
                out[f"{key}_d{d}"] = (*nums, bnd)
            elif d == 6:
                out[key] = (*nums, bnd)
    del fj, geom
    torch.cuda.empty_cache()
    return out


def phase7_caps() -> None:
    """One shape past each cap that the card kernels once had, kernel
    against plain version: the ContConv collect and its backward (B3-B6) at
    k = 72, co = 136 and D = 11; a layer's position gradient at ci = 136
    (the kernel layer against the dense one); ``knn_morton(impl="kernel")``
    at k = 40 on 20,000 bodies (B7 in slabs, B8 on 160-wide rows) against
    its run on the CPU, with recall against exact kNN; B8 on 160-wide edge
    rows, bit for bit."""
    import torch

    from nbody_tpu_torch.experiments.knn_recall import recall_of
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.experiments.select_bench import merge_edge_rows
    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import ContinuousConv
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.ops.knn import knn_neighbors
    from nbody_tpu_torch.ops.radius import radius_neighbors

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    for m, k, ci, co, d in ((300, 72, 16, 16, 3), (300, 8, 16, 136, 3), (300, 8, 8, 8, 11)):
        g3 = [(torch.rand(m, k, generator=gen) * (d + 0.4) - 0.3).to(dev) for _ in range(3)]
        win = (torch.rand(m, k, generator=gen) * (torch.rand(m, k, generator=gen) > 0.2)).to(dev)
        args = (*g3, win, torch.randn(m, k, ci, generator=gen).to(dev),
                torch.randn(d ** 3, ci, co, generator=gen).to(dev))
        dout = torch.randn(m, co, generator=gen).to(dev)
        label = f"M={m} k={k} ci={ci} co={co} D={d}"
        out = cck.contconv_collect(*args, d=d)
        want = cck.contconv_collect_torch(*args, d=d)
        rel = float((out - want).abs().max()) / float(want.abs().max())
        same = torch.equal(out, cck.contconv_collect(*args, d=d))
        log(f"[7c] B3 collect {label}: max|d|/max|out| {rel:.3e} (bar {B3_TOL}), same bits "
            f"twice {same}")
        if not (rel <= B3_TOL and same):
            raise AssertionError(f"B3 past its old caps ({label}): {rel}, same bits {same}")
        _bwd_against_plain(args, dout, d, label, time_it=False)
        _b6_pass_against_plain(args, dout, d, label)

    # a layer's position gradient at ci = 136: B6 on 136 channels
    n, ci = 500, 136
    layer = ContinuousConv(ci, 8, filter_resolution=4, radius=1.0, key=prng.PRNGKey(24)).to(dev)
    pos, _, _ = generate_spiral(prng.PRNGKey(25), n, device=dev)
    idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
    feat = torch.randn(1, n, ci, generator=gen).to(dev)
    cot = torch.randn(1, n, 8, generator=gen).to(dev)

    def pos_grad(impl):
        layer.impl = impl
        q = pos[None].clone().requires_grad_(True)
        (layer(q, feat, idx[None], valid[None]) * cot).sum().backward()
        return q.grad

    before = cck.contconv_bwd_geom.launches
    got = pos_grad("kernel")
    ran = cck.contconv_bwd_geom.launches - before
    want = pos_grad("dense")
    scale = float(want.abs().max())
    worst = float((got - want).abs().max()) / scale
    log(f"[7c] position gradient at ci={ci}, N={n}: kernels (B6 launches {ran}) vs dense "
        f"layer max|d|/max|ref| {worst:.3e} (rtol {MODEL_RTOL}, atol {MODEL_ATOL} x max|ref|)")
    if ran != 1 or not torch.allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
        raise AssertionError(f"position gradient at ci={ci}: B6 launches {ran}, {worst}")

    # the Morton search at k = 40: B7 in slabs of 32, B8 on rows of 160
    k = 40
    pos, _, _ = generate_spiral(prng.PRNGKey(BIG_N + k), BIG_N, device=dev)
    runs = (sp.morton_select.launches, sp.morton_merge.launches)
    got = sp.knn_morton(pos, k, impl="kernel")
    ran = (sp.morton_select.launches - runs[0], sp.morton_merge.launches - runs[1])
    cpu = sp.knn_morton(pos.cpu(), k, impl="kernel")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))
    rec = recall_of(*got, *knn_neighbors(pos, k))
    log(f"[7c] knn_morton(kernel) N={BIG_N} k={k}: launches (B7, B8) {ran}, card == CPU "
        f"twins {same}, recall vs exact {rec:.5f} (bar {RECALL})")
    if not (same and rec >= RECALL and ran == (1, 1)):
        raise AssertionError(f"Morton kNN at k={k}: same {same}, recall {rec}, launches {ran}")
    mc, md = (t.to(dev) for t in merge_edge_rows(EDGE_ROWS, 4 * k, k, seed=4 * k, inf=True))
    got, want = sp.morton_merge(mc, md, k), sp.morton_merge_torch(mc, md, k)
    same = torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                        want[1].view(torch.int32))
    log(f"[7c] B8 merge on {EDGE_ROWS} edge rows, w={4 * k} k={k}: ids and bits equal to its "
        f"plain version {same}")
    if not same:
        raise AssertionError(f"B8 disagrees with its plain version on {4 * k}-wide rows")
    torch.cuda.synchronize()


def phase7_model_gradients() -> int:
    """The full-width model's parameter and position gradients, kernels
    against the dense layer on one graph. Returns B6's launches on the
    kernel run (the position-gradient path)."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.models import ContinuousConvModel
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.train.graphs import build_graph

    dev = torch.device("cuda")
    model = ContinuousConvModel(**FULL_CONTCONV, key=prng.PRNGKey(5)).to(dev).train()
    pos, vel, mass = generate_spiral(prng.PRNGKey(6), GRAD_N, device=dev)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, pos[None])
    cot = torch.randn(1, GRAD_N, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    wrappers = (cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom)

    def grads(impl):
        for conv in model.convs:
            conv.impl = impl
        model.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        (model(xg, idx, valid) * cot).sum().backward()
        torch.cuda.synchronize()
        return {n: p.grad for n, p in model.named_parameters()}, xg.grad[..., :3]

    want, want_pos = grads("dense")
    for w in wrappers:
        w.launches = 0
    got, got_pos = grads("kernel")
    launches = [w.launches for w in wrappers]
    log(f"[7] full-width model gradient N={GRAD_N} (kernel impl): launches B3 "
        f"{launches[0]}, B4 {launches[1]}, B5 {launches[2]}, B6 {launches[3]}")
    if launches != [2, 2, 2, 2]:
        raise AssertionError(f"the model's gradient did not go through B3-B6: {launches}")
    # A batch norm in train mode subtracts the batch mean, so the bias of
    # the Linear layer before it has a zero gradient up to rounding noise,
    # which differs between any two summation orders: left out.
    noise = {f"encoder.layers.{i}.bias" for i in range(len(model.encoder.norms))}
    worst = 0.0
    for name, ref in [*want.items(), ("positions", want_pos)]:
        if name in noise:
            continue
        g = got_pos if name == "positions" else got[name]
        scale = float(ref.abs().max())
        worst = max(worst, float((g - ref).abs().max()) / max(scale, 1e-30))
        if not torch.allclose(g, ref, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
            raise AssertionError(f"gradient of {name}: kernels disagree with dense")
    log(f"[7] full-width model gradients, kernels vs dense, {len(want) - len(noise)} "
        f"parameters and the positions: worst max|d|/max|ref| {worst:.3e} (rtol "
        f"{MODEL_RTOL}, atol {MODEL_ATOL} x max|ref|)")
    _b6_at_its_launch_shape(model, pos, idx, valid)
    return launches[3]


def _b6_at_its_launch_shape(model, pos, idx, valid) -> None:
    """B6's device ms and bound at the shape where its counted launches run:
    each layer of the full-width model on the GRAD_N-body graph, with
    random features and cotangents of the layer's widths and its filters."""
    import torch

    from nbody_tpu_torch.experiments.contconv_bench import b6_bound_ms
    from nbody_tpu_torch.models.contconv import conv_geometry
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.utils.timing import cuda_time_ms, kernel_events

    gen = torch.Generator().manual_seed(8)
    for conv in model.convs:
        d, ci, co = conv.filter_resolution, conv.in_channels, conv.out_channels
        geom = conv_geometry(pos[None], idx, valid, conv.radius)
        grid = ((geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)).contiguous()
        gx, gy, gz = (grid[..., a].contiguous() for a in range(3))
        win = geom["window"][0].contiguous()
        m, k = win.shape
        args = (gx, gy, gz, win, torch.randn(m, k, ci, generator=gen).to(pos.device),
                conv.filters.detach().reshape(d ** 3, ci, co).contiguous(),
                torch.randn(m, co, generator=gen).to(pos.device))

        def b6():
            return cck.contconv_bwd_geom(*args, d=d)

        ms = cuda_time_ms(b6, reps=10, warmup=1)
        events = kernel_events(b6, reps=10)
        geom = [t for n, t in events if "bwd_geom" in n]
        if not geom:  # the profiler's recording began late: sessions for the pass alone
            geom = [t for _, t in kernel_events(b6, reps=10, name="bwd_geom")]
        bnd = b6_bound_ms((gx, gy, gz), win, ci, co, d)
        log(f"[7] B6 at its launch shape (N={GRAD_N}, k={k}, ci={ci}, co={co}, D={d}): "
            f"{sum(t for _, t in events) / 10:.4f} device ms a call in {len(events) / 10:g} "
            f"kernels (plan, dG product, geometry pass; {sum(geom) / max(len(geom), 1):.4f} "
            f"the pass, {len(geom)} events of 10 calls), {ms:.4f} ms by events around the "
            f"wrapper; bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not geom:
            raise AssertionError("B6 left no kernel event at its launch shape")


def _sets(*overrides):
    return [a for o in overrides for a in ("--set", o)]


def _epoch_numbers(trainer, data_dir, batch_size, steps, **kw):
    """ms per optimiser step of a warm epoch, and the idle share and top
    device rows (ms per step) of one more, profiled."""
    import torch

    from nbody_tpu_torch.utils.timing import device_time, profile_ms

    def epoch():
        return trainer.train_from_dir(data_dir, epochs=1, batch_size=batch_size,
                                      verbose=False, **kw)

    epoch()  # warm-up
    (losses, _), sec = device_time(epoch, trainer.device)
    busy_ms, top = profile_ms(epoch, trainer.device, top=24)  # B3-B5 kernels too
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    torch.cuda.synchronize()
    return 1e3 * sec / steps, 1.0 - busy_ms / 1e3 / sec, [(n, t / steps) for n, t in top]


def elastic_on_the_card(cfg, train_dir: str, save_path: str) -> None:
    """``elastic_train`` on the recipe cut that phase 8a trains, 3 epochs,
    with one fault: the weights poisoned once after epoch 2's health check,
    so epoch 2's checkpoint is unhealthy and epoch 3 faults. The run must
    restart once, from epoch 1's checkpoint (the last healthy one), at the
    learning rate times ``lr_backoff``, and end with finite losses."""
    import torch

    from nbody_tpu_torch.train import Trainer, all_finite, elastic_train

    dev = torch.device("cuda")
    trainer = Trainer(cfg.build_model().to(dev), learning_rate=cfg.train.learning_rate,
                      dt=cfg.train.dt, seed=2)
    seen, state = [], {"armed": True}

    def poison_once(epoch, losses, mses):
        seen.append(epoch)  # the epochs that passed the health check, in order
        if epoch == 2 and state["armed"]:
            state["armed"] = False
            with torch.no_grad():
                for p in trainer.model.parameters():
                    p.fill_(float("nan"))

    t0 = time.perf_counter()
    res = elastic_train(trainer, train_dir, epochs=3, batch_size=cfg.train.batch_size,
                        save_path=save_path, save_every=1, max_restarts=2, lr_backoff=0.5,
                        verbose=False, on_epoch_end=poison_once, merge_files=True,
                        batch_mode="mixed")
    lr = trainer.optimizer.param_groups[0]["lr"]
    log(f"[8a] elastic_train, 3 epochs, weights poisoned after epoch 2: "
        f"{time.perf_counter() - t0:.2f} s wall, restarts {res.restarts}, faults {res.faults}, epochs through the health "
        f"check {seen}, LR {lr:g} (set {cfg.train.learning_rate:g}), losses {res.epoch_losses}, "
        f"checkpoints {sorted(os.listdir(save_path))}")
    if not (res.restarts == 1 and [e for e, _ in res.faults] == [3] and seen == [1, 2, 2, 3]
            and abs(lr - 0.5 * cfg.train.learning_rate) <= 1e-12 and trainer.epoch == 3
            and len(res.epoch_losses) == 3 and all(math.isfinite(v) for v in res.epoch_losses)
            and all_finite(trainer.model)):
        raise AssertionError("elastic_train did not recover once from epoch 1's checkpoint "
                             "at the backed-off LR with finite losses")


def phase8_training(tmp: str):
    """The training path through the port's entry points; asserts the
    kernels it must (and must not) launch."""
    import numpy as np
    import pandas as pd
    import torch

    from nbody_tpu_torch.config import ExperimentConfig
    from nbody_tpu_torch.data.generate import ScenarioConfig, generate_dataset
    from nbody_tpu_torch.experiments import gnn_experiment, run
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.train import Trainer
    from nbody_tpu_torch.train.trainer import _list_dataset_files

    dev = torch.device("cuda")
    cfg_path = os.path.join(HERE, "configs", "contconv_adopted.json")
    wrappers = (cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom)

    # (a) the config runner at full width: 2 epochs, then a resumed third
    base = os.path.join(tmp, "run")
    argv = ["--config", cfg_path, "--device", "cuda"] + _sets(f"base={base}", *RUN_SETS)
    before = [w.launches for w in wrappers]
    t0 = time.perf_counter()
    first = run.main(argv + _sets("train.epochs=2"))
    wall = time.perf_counter() - t0
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    model = first["trainer"].model
    log(f"[8a] run --config contconv_adopted.json: {wall:.2f} s wall, epoch losses "
        f"{first['epoch_loss']}; launches B3 {counts[0]}, B4 {counts[1]}, B5 {counts[2]}, "
        f"B6 {counts[3]}")
    if not (all(c.impl is None for c in model.convs) and first["trainer"].epoch == 2
            and len(first["epoch_loss"]) == 2
            and all(math.isfinite(v) for v in first["epoch_loss"])):
        raise AssertionError("run did not train the config's model for 2 finite epochs")
    if min(counts[:3]) == 0 or counts[3] != 0:
        raise AssertionError(f"training launches B3-B6 {counts}: B3-B5 > 0, B6 = 0 expected")
    t0 = time.perf_counter()
    again = run.main(argv + _sets("train.epochs=1"))
    wall = time.perf_counter() - t0
    if again["trainer"].epoch != 3 or not math.isfinite(again["epoch_loss"][0]):
        raise AssertionError(f"resume: epoch {again['trainer'].epoch}, {again['epoch_loss']}")
    ckpts = sorted(os.listdir(os.path.join(base, "contconv_weights")))
    results = os.path.join(base, "results", "contconv")
    loss = pd.read_csv(os.path.join(results, "epoch_loss.csv"))
    step = pd.read_csv(os.path.join(results, "test_results_stepwise.csv"))
    roll = pd.read_csv(os.path.join(results, "test_results_rollout.csv"))
    if (ckpts != ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"] or list(loss.columns) != ["loss"]
            or list(step.columns) != ["filename", "scene", "loss", "step_time"]
            or list(roll.columns) != ["filename", "scene", "step", "pos_rmse", "vel_rmse",
                                      "acc_rmse"]
            or not np.isfinite(roll.drop(columns=["filename"]).to_numpy(float)).all()):
        raise AssertionError(f"resumed run: checkpoints {ckpts}, csv columns "
                             f"{list(loss.columns)}, {list(step.columns)}, {list(roll.columns)}")
    log(f"[8a] resumed run: epoch {again['trainer'].epoch}, loss {again['epoch_loss'][0]:.6g}, "
        f"{wall:.2f} s wall; evaluated from {ckpts[-1]}: stepwise loss "
        f"{step['loss'].mean():.6g}, final pos RMSE "
        f"{roll.groupby('scene')['pos_rmse'].last().mean():.6g}")

    train_dir = os.path.join(base, "data", "train")
    cfg = ExperimentConfig.load(cfg_path).apply_overrides(RUN_SETS)
    snaps = sum(again["trainer"]._dataset(f).n_snapshots for f in _list_dataset_files(train_dir))
    steps = -(-snaps // cfg.train.batch_size)
    trainer = Trainer(cfg.build_model().to(dev), learning_rate=cfg.train.learning_rate,
                      dt=cfg.train.dt)
    ms, idle, top = _epoch_numbers(trainer, train_dir, cfg.train.batch_size, steps,
                                   merge_files=True, batch_mode="mixed")
    log(f"[8a] recipe-shape train step (mixed batches of {cfg.train.batch_size} padded to "
        f"{max(cfg.datagen.n_bodies)} bodies, {steps} steps an epoch): {ms:.4f} ms/step, "
        f"idle share {idle:.4f}, top device rows {_rows(top)}")
    elastic_on_the_card(cfg, train_dir, os.path.join(tmp, "elastic_ckpt"))

    # (b) the GNN experiment
    t0 = time.perf_counter()
    gnn = gnn_experiment.main(["--quick", "--base", os.path.join(tmp, "gnn"), "--seed", "3",
                               "--device", "cuda", "--check"])
    if gnn["trainer"].epoch != 3 or not all(math.isfinite(v) for v in gnn["epoch_loss"]):
        raise AssertionError(f"gnn_experiment --quick: {gnn['epoch_loss']}")
    log(f"[8b] gnn_experiment --quick: {time.perf_counter() - t0:.2f} s wall, losses "
        f"{gnn['epoch_loss']}")

    # (c) the 100k training step on a strided port-datagen dataset
    def dataset(n):
        out = os.path.join(tmp, f"large_{n}")
        os.makedirs(out)
        generate_dataset([ScenarioConfig(n_bodies=n, sim_type="spiral", steps=TRAIN_STEPS,
                                         dt=DT, softening=EPS, g=G, seed=11,
                                         force_backend="kernel", calc_energy=False)],
                         os.path.join(out, f"spiral_{n}.csv"), write_csv_file=False,
                         snapshot_stride=TRAIN_STRIDE, device=dev, verbose=False)
        return out

    def step_numbers(impl, data_dir):
        cfg_n = cfg.apply_overrides(["model.kwargs.radius_method=morton",
                                     "model.kwargs.radius_impl=kernel",
                                     f"model.kwargs.conv_impl={impl}"])
        trainer = Trainer(cfg_n.build_model().to(dev), learning_rate=cfg.train.learning_rate,
                          dt=DT, seed=1)
        snaps = trainer._dataset(_list_dataset_files(data_dir)[0]).n_snapshots
        return _epoch_numbers(trainer, data_dir, 1, snaps), snaps

    large = dataset(LARGE_N)
    before = [w.launches for w in wrappers]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (ms_k, idle_k, top_k), snaps = step_numbers("kernel", large)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    # B5's own kernels: the gathered grouped product and the unbin pass
    b5_ms = sum(t for name, t in top_k if "pair_product_kernel<true>" in name
                or "unbins_kernel" in name)
    log(f"[8c] train step N={LARGE_N} kernels (Morton radius, batch 1, {snaps} snapshots): "
        f"{ms_k:.4f} ms/step, idle share {idle_k:.4f}, peak memory {peak:.3f} GiB, B5 (dG "
        f"product + unbins) {b5_ms:.4f} ms/step = {b5_ms / ms_k:.4f} of the step; top device "
        f"rows {_rows(top_k)}; launches B3 {counts[0]}, B4 {counts[1]}, B5 {counts[2]}, "
        f"B6 {counts[3]}")
    if min(counts[:3]) == 0 or counts[3] != 0:
        raise AssertionError(f"100k training launches B3-B6 {counts}")
    torch.cuda.empty_cache()
    try:
        (ms_d, idle_d, top_d), _ = step_numbers("dense", large)
        n_dense = LARGE_N
    except torch.cuda.OutOfMemoryError:
        log(f"[8c] the dense layer's training step at N={LARGE_N} does not fit in memory")
        torch.cuda.empty_cache()
        n_dense = BIG_N
        (ms_d, idle_d, top_d), _ = step_numbers("dense", dataset(BIG_N))
    log(f"[8c] train step N={n_dense} dense layer: {ms_d:.4f} ms/step, idle share "
        f"{idle_d:.4f}, top device rows {_rows(top_d)}; kernels at N={LARGE_N}: "
        f"{ms_k:.4f} ms/step")


def _rows(top):
    return "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in top)


def _against_plain(label, kernel, plain, tol, bound_, name, tag="9a", time_it=True):
    """A kernel call against its plain version on the same inputs, twice for
    the same bits; with ``time_it``, its ms between events around 10 wrapper
    calls, and its device ms: the events of kernels whose name holds
    ``name``, summed and divided by their count (:func:`kernel_events`).
    Returns (max abs err, kernel ms, plain ms, bound)."""
    import torch

    from nbody_tpu_torch.utils.timing import cuda_time_ms, kernel_events

    got, again = kernel(), kernel()
    same = torch.equal(got, again)
    want = plain()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not time_it:
        log(f"[{tag}] {label}: max|d|/max|plain| {rel:.3e} (bar {tol}), same bits twice {same}")
        if not (rel <= tol and same and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{label}: the kernel disagrees with its plain version "
                                 f"({rel}, same bits {same})")
        return err, None, None, bound_
    ms = cuda_time_ms(kernel, reps=10, warmup=1)
    events = [t for _, t in kernel_events(kernel, reps=10, name=name)]
    device_ms = sum(events) / max(len(events), 1)
    plain_ms = cuda_time_ms(plain, reps=2, warmup=1)
    log(f"[{tag}] {label}: max|d|/max|plain| {rel:.3e} (bar {tol}), same bits twice {same}; "
        f"kernel {ms:.4f} ms (events around the wrapper), {device_ms:.4f} device ms "
        f"({len(events)} events of 10 calls)  plain {plain_ms:.4f} ms  bound "
        f"{bound_[0]:.4f} ms ({bound_[1]})")
    if not (rel <= tol and same and bool(torch.isfinite(got).all()) and events):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version "
                             f"({rel}, same bits {same}) or left no event ({len(events)})")
    return err, ms, plain_ms, bound_


def _tree_shapes(n, seed, build, knobs, tag="9a"):
    """A spiral of n bodies on the card and its partition, with the build's
    time logged."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng

    pos, _, mass = generate_spiral(prng.PRNGKey(seed), n,
                                   device=torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = build(pos, mass, **knobs)
    torch.cuda.synchronize()
    log(f"[{tag}] N={n} {build.__name__}({knobs}): {time.perf_counter() - t0:.4f} s "
        f"(first call), near {tuple(part.near.shape)}")
    return pos, mass, part


def _table(tf, spos, sm, rows):
    nb = spos.shape[0] // rows
    bp, _, msum, com, quad = tf._block_moments(spos, sm, nb, rows)
    return bp.contiguous(), tf._blk_rows(com, msum, quad)


def phase9_kernels():
    """B9, B10 and B1's near-list form against their plain versions on the
    shapes of the 100k bh and 1M bh3 recipes; returns the kernels line's
    numbers (the 1M bh3 shapes)."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf

    eps2 = EPS ** 2
    pos, mass, part = _tree_shapes(TREE_N, TREE_N + 9, tf.build_bh_partition, BH_100K)
    spos, sm = tf._gather_sorted(pos, mass, part)
    b = BH_100K["block"]
    q_blocks, table = _table(tf, spos, sm, b)
    (nb, m), p, k = part.near.shape, spos.shape[0], table.shape[0]
    _against_plain(f"B9 far field N={TREE_N}: {p} receivers x {k} blocks",
                   lambda: tf.multipole_acc(spos, table, G, eps2),
                   lambda: tf.multipole_acc_torch(spos, table, G, eps2), MULT_TOL,
                   bound(45.0 * p * k, 24.0 * p + 40.0 * k), B9_NAME)
    all_rows = torch.arange(k, dtype=torch.int32, device=spos.device)[None]
    same = torch.equal(tf.multipole_acc(spos, table, G, eps2),
                       tf.grouped_multipole_acc(spos[None], table, all_rows, G, eps2)[0])
    log(f"[9a] B9 N={TREE_N} equals B10 given one group and all {k} rows, bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("B9 differs from B10's receiver loop over every row")
    _against_plain(f"B10 near subtraction N={TREE_N}: {nb} groups x {b} x {m} blocks",
                   lambda: tf.grouped_multipole_acc(q_blocks, table, part.near, G, eps2),
                   lambda: tf.grouped_multipole_acc_torch(q_blocks, table, part.near, G, eps2),
                   MULT_TOL, bound(45.0 * p * m, 24.0 * p + 40.0 * k + 4.0 * nb * m), B10_NAME)
    _against_plain(f"B1 near list N={TREE_N}: {nb} groups x {b} x {m} blocks of {b}",
                   lambda: pw.near_accelerations(q_blocks, spos, sm, part.near, b, G, EPS),
                   lambda: pw.near_accelerations_torch(q_blocks, spos, sm, part.near, b, G,
                                                       EPS),
                   B1_TOL, bound(20.0 * p * m * b, 24.0 * p + 16.0 * p + 4.0 * nb * m), NEAR_NAME)
    del pos, mass, part, spos, sm, q_blocks, table

    pos, mass, part = _tree_shapes(TREE_1M, TREE_1M + 9, tf.build_bh3_partition, BH3_1M)
    cases = _two_level_cases(pos, mass, part, BH3_1M)
    out = {}
    for key, case in zip(("b9", "b10", None, None, None, "b1n"), cases):
        numbers = _against_plain(*case)
        if key:
            out[key] = numbers
    del pos, mass, part, cases
    torch.cuda.empty_cache()
    return out


def _two_level_cases(pos, mass, part, knobs):
    """``_against_plain``'s arguments for every launch of a bh2 or bh3 force
    evaluation on ``part``, in the engine's order: B9 over the superblocks,
    B10's refinement, coarse and near subtraction (bh3: and its sub-block
    multipoles), B1's near list (bh3: over sub-blocks)."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf

    eps2, n = EPS ** 2, pos.shape[0]
    spos, sm = tf._gather_sorted(pos, mass, part)
    b, c = knobs["block"], knobs["coarse"]
    q_blocks, table_f = _table(tf, spos, sm, b)
    _, table_c = _table(tf, spos, sm, b * c)
    p, (nbc, rc), nb = spos.shape[0], part.refined.shape, part.n_blocks
    fine_ids = (part.refined[:, :, None] * c + torch.arange(
        c, dtype=torch.int32, device=spos.device)).reshape(nbc, rc * c).contiguous()
    qg = spos.reshape(nbc, c * b, 3)

    def b10(what, q, table, ids, unit):
        return (f"B10 {what} N={n}: {ids.shape[0]} groups x {q.shape[1]} x {ids.shape[1]} "
                f"{unit}",
                lambda: tf.grouped_multipole_acc(q, table, ids, G, eps2),
                lambda: tf.grouped_multipole_acc_torch(q, table, ids, G, eps2), MULT_TOL,
                bound(45.0 * p * ids.shape[1], 24.0 * p + 40.0 * table.shape[0]
                      + 4.0 * ids.numel()), B10_NAME)

    cases = [
        (f"B9 far field N={n}: {p} receivers x {nbc} superblocks",
         lambda: tf.multipole_acc(spos, table_c, G, eps2),
         lambda: tf.multipole_acc_torch(spos, table_c, G, eps2), MULT_TOL,
         bound(45.0 * p * nbc, 24.0 * p + 40.0 * nbc), B9_NAME),
        b10("refinement", qg, table_f, fine_ids, "fine blocks"),
        b10("coarse subtraction", qg, table_c, part.refined, "superblocks"),
        b10("near subtraction", q_blocks, table_f, part.near, "blocks"),
    ]
    near, src_block = part.near, b
    if "sub_block" in knobs:
        src_block = knobs["sub_block"]
        _, table_s = _table(tf, spos, sm, src_block)
        cases.append(b10("sub-block multipoles", q_blocks, table_s, part.sub_far, "sub-blocks"))
        near = part.sub_near
    kk = near.shape[1]
    cases.append((f"B1 near list N={n}: {nb} groups x {b} x {kk} blocks of {src_block}",
                  lambda: pw.near_accelerations(q_blocks, spos, sm, near, src_block, G, EPS),
                  lambda: pw.near_accelerations_torch(q_blocks, spos, sm, near, src_block, G,
                                                      EPS),
                  B1_TOL, bound(20.0 * p * kk * src_block, 24.0 * p + 16.0 * p + 4.0 * nb * kk),
                  NEAR_NAME))
    return cases


def phase9_engines():
    """Each engine's kernel path against its dense path on one partition at
    100k bodies, elementwise at the JAX tests' bar between their two near
    paths. At 100k a few elements in 10^5 miss that bar through float32
    cancellation at the near/far seam, shared by the two paths: the float32
    dense path misses it as often against its own float64 run, which is
    printed beside. So the check is: at most ``SEAM_SHARE`` of the elements
    over the bar, and the kernel path's median force error against the
    exact sum (B1) no larger than the dense path's."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    pos, _, mass = generate_spiral(prng.PRNGKey(TREE_N + 11), TREE_N,
                                   device=torch.device("cuda"))
    exact = pw.accelerations(pos, mass, G, EPS)
    two = dict(n_near=32, block=128, coarse=16, rc=32)
    runs = {"bh": (tf.build_bh_partition, tf.bh_accelerations, BH_100K),
            "bh2": (tf.build_bh2_partition, tf.bh2_accelerations, two),
            "bh3": (tf.build_bh3_partition, tf.bh3_accelerations,
                    dict(two, sub_block=32, n_sub=48))}
    for name, (build, engine, knobs) in runs.items():
        part = build(pos, mass, **knobs)

        def run(impl, p_=pos, m_=mass):
            return engine(p_, m_, G, EPS, partition=part, near_impl=impl)

        got, dense = run("kernel"), run("dense")
        f64 = run("dense", pos.double(), mass.double())

        def over(a, b):
            e = (a.double() - b.double()).abs() - (NEAR_ATOL[name] + 2e-3 * b.double().abs())
            return int((e > 0).sum()), float(e.max())

        def median_err(a):
            return float(((a - exact).norm(dim=-1) / (exact.norm(dim=-1) + 1e-30)).median())

        n_over, worst = over(got, dense)
        meds = [median_err(got), median_err(dense)]
        ms = cuda_time_ms(lambda: run("kernel"), reps=5, warmup=1)
        ms_d = cuda_time_ms(lambda: run("dense"), reps=2, warmup=1)
        log(f"[9b] {name} {knobs} N={TREE_N}: elements over rtol 2e-3 + atol "
            f"{NEAR_ATOL[name]}: kernel vs dense {n_over} of {got.numel()} (worst excess "
            f"{worst:.3e}), float32 dense vs float64 dense {over(dense, f64)[0]}, kernel vs "
            f"float64 dense {over(got, f64)[0]}; median rel error vs exact: kernel "
            f"{meds[0]:.4e}, dense {meds[1]:.4e}; force evaluation (reused partition) "
            f"kernel {ms:.4f} ms, dense {ms_d:.4f} ms")
        if not (n_over <= SEAM_SHARE * got.numel() and meds[0] <= meds[1]):
            raise AssertionError(f"{name}: the kernel path disagrees with the dense path")
    torch.cuda.synchronize()


def phase9_rollouts():
    """The treecode path through ``bh_rollout.main``: bh at 100k with the
    exact energy audit, bh3 at 1M with the sampled force audit."""
    from nbody_tpu_torch.experiments import bh_rollout

    bh = bh_rollout.main(["--engine", "bh", "--n-bodies", str(TREE_N), "--steps", "200",
                          "--bh-refresh", "8", "--device", "cuda", "--profile"])
    log(f"[9c] bh_rollout bh N={TREE_N} x 200 steps (refresh 8): "
        f"{bh['ms_per_step']:.4f} ms/step, {bh['wall_s']:.4f} s wall, energy drift "
        f"{bh['rel_energy_drift']:.3e} (bar {BH_DRIFT})")
    if not bh["rel_energy_drift"] < BH_DRIFT:
        raise AssertionError(f"100k bh energy drift {bh['rel_energy_drift']}")
    log(f"[9c] bh N={TREE_N}: {_profile_line(bh)}")
    bh3 = bh_rollout.main(["--engine", "bh3", "--n-bodies", str(TREE_1M), "--block", "128",
                           "--rc", "48", "--n-sub", "48", "--steps", "16", "--chunk-steps",
                           "8", "--no-energy-audit", "--device", "cuda", "--profile"])
    log(f"[9c] bh_rollout bh3 N={TREE_1M} x 16 steps (chunks of 8, refresh 8): "
        f"{bh3['ms_per_step']:.4f} ms/step, {bh3['wall_s']:.4f} s wall; sampled force error "
        f"over {bh3['error_sample']} receivers: median {bh3['end_rel_err_median']:.4e} "
        f"(bar {BH3_MEDIAN}), p99 {bh3['end_rel_err_p99']:.4e}")
    if not bh3["end_rel_err_median"] < BH3_MEDIAN:
        raise AssertionError(f"1M bh3 median force error {bh3['end_rel_err_median']}")
    log(f"[9c] bh3 N={TREE_1M}: {_profile_line(bh3)}")


def _profile_line(row) -> str:
    steps = row["profile_steps"]
    return (f"one more {steps}-step segment {1e3 * row['profile_wall_s'] / steps:.4f} ms/step "
            f"wall, {1e3 * row['busy_seconds'] / steps:.4f} ms/step device, idle share "
            f"{row['idle_share']:.4f}, top device rows (ms/step) "
            f"{_rows([(n, t / steps) for n, t in row['top_ms']])}")


def phase9_bench():
    from nbody_tpu_torch.experiments import treeforce_bench

    for engine, extra in (("bh", []), ("bh2", ["--block", "128"]), ("bh3", ["--block", "128"])):
        (row,) = treeforce_bench.main(["--n-bodies", str(TREE_N), "--engine", engine,
                                       "--reps", "5", "--device", "cuda", *extra])
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"treeforce_bench {engine}: {row}")
        log(f"[9d] treeforce_bench {engine} N={TREE_N}: exact {row['exact_ms']:.4f} ms, "
            f"fresh {row['bh_fresh_ms']:.4f}, reused {row['bh_reused_ms']:.4f}, partition "
            f"{row['partition_ms']:.4f}; rel err median {row['rel_err_median']:.4e}, p99 "
            f"{row['rel_err_p99']:.4e}")

def _stacked_spirals(s, n, seed):
    """A group of s spiral scenes of n bodies on the card, (pos, vel, mass)
    stacked on a leading scene axis, scene i from seed + i."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng

    ics = [generate_spiral(prng.PRNGKey(seed + i), n,
                           device=torch.device("cuda")) for i in range(s)]
    return tuple(torch.stack([x[f] for x in ics]) for f in range(3))


def phase12_group_kernels() -> dict:
    """B9, B10 and B1's near list on a scene axis, at the shapes of a 4 x 100k
    bh group (M = 32, B = 256): one launch a call, against the plain
    version, each scene bit for bit the kernel's call on it alone; returns
    the kernels line's numbers."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf

    s, n, _ = GROUP_BH
    pos, _, mass = _stacked_spirals(s, n, 120)
    part = tf.build_bh_partition(pos, mass, **BH_100K)
    spos, sm = tf._gather_sorted(pos, mass, part)
    (nb, m), b = part.near.shape[1:], BH_100K["block"]
    bp, _, msum, com, quad = tf._block_moments(spos, sm, nb, b)
    q_blocks, table = bp.contiguous(), tf._blk_rows(com, msum, quad)
    p, eps2 = spos.shape[1], EPS ** 2
    cases = {
        "b9g": (f"B9 far field, {s} scenes x {p} receivers x {nb} blocks",
                lambda *a: tf.multipole_acc(*a, G, eps2), tf.multipole_acc_torch,
                (spos, table), (G, eps2), MULT_TOL,
                bound(45.0 * s * p * nb, s * (24.0 * p + 40.0 * nb)), B9_NAME),
        "b10g": (f"B10 near subtraction, {s} scenes x {nb} groups x {b} x {m} blocks",
                 lambda *a: tf.grouped_multipole_acc(*a, G, eps2),
                 tf.grouped_multipole_acc_torch, (q_blocks, table, part.near), (G, eps2),
                 MULT_TOL, bound(45.0 * s * p * m, s * (24.0 * p + 40.0 * nb + 4.0 * nb * m)),
                 B10_NAME),
        "b1ng": (f"B1 near list, {s} scenes x {nb} groups x {b} x {m} blocks of {b}",
                 lambda *a: pw.near_accelerations(*a, b, G, EPS), pw.near_accelerations_torch,
                 (q_blocks, spos, sm, part.near), (b, G, EPS), B1_TOL,
                 bound(20.0 * s * p * m * b, s * (24.0 * p + 16.0 * p + 4.0 * nb * m)),
                 NEAR_NAME)}
    out = {}
    for key, (label, kernel, plain, args, consts, tol, bnd, name) in cases.items():
        wrapper = kernel_wrappers()[key[:-1]]
        before = wrapper.launches
        got = kernel(*args)
        one_launch = wrapper.launches == before + 1
        alone = all(torch.equal(got[i], kernel(*(a[i] for a in args))) for i in range(s))
        log(f"[12a] {label}: one launch {one_launch}, each scene the bits of its own call "
            f"{alone}")
        if not (one_launch and alone):
            raise AssertionError(f"{label}: one launch {one_launch}, scenes alone {alone}")
        out[key] = _against_plain(label, lambda: kernel(*args), lambda: plain(*args, *consts),
                                  tol, bnd, name, tag="12a")
    del pos, mass, part, spos, sm, q_blocks, table
    torch.cuda.empty_cache()
    return out


def _group_config(engine, knobs, calc_energy):
    from nbody_tpu_torch.core import SimulationConfig

    return SimulationConfig(g_const=G, softening=EPS, dt=DT, calc_energy=calc_energy,
                            force_backend=engine, bh_near=knobs["n_near"],
                            bh_block=knobs["block"], bh_coarse=knobs.get("coarse", 16),
                            bh_rc=knobs.get("rc", 32), bh_sub_block=knobs.get("sub_block", 32),
                            bh_n_sub=knobs.get("n_sub", 24), bh_refresh=GROUP_REFRESH)


def _wall_and_idle(run, label):
    """ms of one more call of ``run`` (after one untimed), and its idle share:
    1 - device ms (profiler kernel rows) / that wall ms."""
    from nbody_tpu_torch.utils.timing import device_time, profile_ms

    run()
    _, wall = device_time(run, "cuda")
    busy, top = profile_ms(run, "cuda")
    log(f"[12b] {label}: {1e3 * wall:.4f} ms wall, {busy:.4f} device ms, idle share "
        f"{1 - busy / (1e3 * wall):.4f}; top device rows {_rows(top)}")
    return 1e3 * wall, 1 - busy / (1e3 * wall)


def phase12_group_rollout(engine, knobs, group, calc_energy, seed) -> dict:
    """One treecode group of ``group = (scenes, bodies, steps)`` through
    ``simulate``, the counters at 0 just before it and read just after: B9
    and the near list once a force evaluation of the group, B10 once (bh)
    or 4 times (bh3), B2 once a step with energies. Then each scene alone,
    equal to its scene of the group bit for bit in every field, and ms a
    step a scene both ways with the idle share (the bh group also without
    energies). Returns the group run's launches."""
    import torch

    from nbody_tpu_torch.core import simulate
    from nbody_tpu_torch.utils.timing import device_time

    s, n, steps = group
    pos, vel, mass = _stacked_spirals(s, n, seed)
    cfg = _group_config(engine, knobs, calc_energy)
    zero_counts()
    traj, wall_g = device_time(lambda: simulate(pos, vel, mass, steps, cfg), "cuda")
    ran = read_counts()
    evals = steps + 1
    want = {"b9": evals, "b1n": evals, "b10": evals * (4 if engine == "bh3" else 1),
            "b2": steps if calc_energy else 0}
    log(f"[12b] {engine} group {s} x {n} x {steps} steps (refresh {GROUP_REFRESH}, energies "
        f"{calc_energy}): launches {ran}; {evals} force evaluations")
    if any(ran[k] != v for k, v in want.items()):
        raise AssertionError(f"{engine} group launches {ran}, want {want}: each kernel once "
                             "a force evaluation of the whole group")
    walls = []
    for i in range(s):
        alone, wall = device_time(lambda: simulate(pos[i], vel[i], mass[i], steps, cfg), "cuda")
        walls.append(wall)
        fields = [f for f, g_, a_ in zip(traj._fields, traj, alone)
                  if not (g_ is None and a_ is None) and not torch.equal(g_[:, i], a_)]
        if fields:
            raise AssertionError(f"{engine} group scene {i}: {fields} differ from its run alone")
        del alone
    log(f"[12b] {engine} group {s} x {n}: every scene's trajectory the bits of its run "
        f"alone; {1e3 * wall_g / (steps * s):.4f} ms a step a scene grouped, one by one "
        f"{[round(1e3 * w / steps, 4) for w in walls]}")
    del traj
    timed = [(cfg, "")]
    if calc_energy:  # the step itself, without the energies' B2
        timed.append((_group_config(engine, knobs, False), ", no energies"))
    for c, note in timed:
        g_ms, g_idle = _wall_and_idle(lambda: simulate(pos, vel, mass, steps, c),
                                      f"{engine} {s} x {n} x {steps} grouped{note}")
        a_ms, a_idle = _wall_and_idle(lambda: simulate(pos[0], vel[0], mass[0], steps, c),
                                      f"{engine} {n} x {steps}, scene 0 alone{note}")
        log(f"[12b] {engine} {s} x {n}{note}: {g_ms / (steps * s):.4f} ms a step a scene "
            f"grouped (idle share {g_idle:.4f}) against {a_ms / steps:.4f} one by one (idle "
            f"share {a_idle:.4f})")
    del pos, vel, mass
    torch.cuda.empty_cache()
    return ran


def phase12_morton() -> tuple:
    """A batch's Morton graph (4 x 100k, k = 32, block 256, 4 copies) through
    ``batched_knn_morton``, the counters at 0 just before it and read just
    after: one B7 and one B8 launch, each scene the ids of its own call; then
    B7 on the batch's B x C copies and B8 on its B x N rows against their
    plain versions, with times. Returns (the launches, the kernels line's
    numbers)."""
    import torch

    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    s, n, k = MORTON_GROUP
    pos = _stacked_spirals(s, n, 140)[0]

    def batched():
        return sp.batched_knn_morton(pos, k, block=256, n_copies=4, impl="kernel")

    zero_counts()
    idx, valid = batched()
    ran = read_counts()
    log(f"[12c] batched Morton graph {s} x {n}, k={k}: launches {ran}")
    if ran["b7"] != 1 or ran["b8"] != 1:
        raise AssertionError(f"a batch's Morton graph launched B7 {ran['b7']}, B8 {ran['b8']} "
                             "times, not once each")
    alone = [sp.knn_morton(pos[i], k, block=256, n_copies=4, impl="kernel") for i in range(s)]
    same = all(torch.equal(idx[i], a[0]) and torch.equal(valid[i], a[1])
               for i, a in enumerate(alone))
    ms_b = cuda_time_ms(batched, reps=5, warmup=1)
    ms_a = cuda_time_ms(lambda: [sp.knn_morton(pos[i], k, block=256, n_copies=4,
                                               impl="kernel") for i in range(s)],
                        reps=5, warmup=1)
    log(f"[12c] each scene the ids and validity of its own call: {same}; batched "
        f"{ms_b:.4f} ms ({ms_b / s:.4f} a scene), {s} calls {ms_a:.4f} ms")
    if not same:
        raise AssertionError("the batched Morton graph differs from the per-scene calls")
    order = sp._curve_order(pos, None, 4)
    cand, qg = sp._candidates(pos, order, 256)
    ids, d2 = sp.morton_select(cand, k, 256, False)
    mc, md = sp._to_rows(qg, ids, d2, n, s)
    m_ids, _ = sp.morton_merge(mc, md, k)
    bnd7, bnd8 = select_merge_bounds(cand, ids, mc, m_ids, k, 256)
    out = {}
    for key, label, kernel, plain, bnd, name in (
            ("b7g", f"B7 select, {s} scenes x 4 copies = {cand.shape[0]} copies of {n}",
             lambda: sp.morton_select(cand, k, 256, False)[1],
             lambda: sp.morton_select_torch(cand, k, 256, False)[1], bnd7, "select_kernel"),
            ("b8g", f"B8 merge, {s} x {n} = {mc.shape[0]} rows of {mc.shape[1]}",
             lambda: sp.morton_merge(mc, md, k)[1], lambda: sp.morton_merge_torch(mc, md, k)[1],
             bnd8, "merge_kernel")):
        out[key] = _against_plain(label, kernel, plain, 1e-6 if key == "b7g" else 0.0, bnd,
                                  name, tag="12c")
    same_ids = (torch.equal(ids, sp.morton_select_torch(cand, k, 256, False)[0])
                and torch.equal(m_ids, sp.morton_merge_torch(mc, md, k)[0]))
    log(f"[12c] B7's and B8's ids equal their plain versions': {same_ids}")
    if not same_ids:
        raise AssertionError("B7 or B8 ids differ from their plain versions on the batch")
    del pos, cand, qg, ids, d2, mc, md
    torch.cuda.empty_cache()
    return ran, out


def _large_run(label: str, fn, need) -> dict:
    """One entry point's ``main`` on the card, the counters at 0 just before
    it and read just after: every kernel of ``need`` must have launched.
    Prints its peak memory (``torch.cuda.max_memory_allocated`` from the
    start of the call) and its wall time on lines of their own."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    row = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = read_counts()
    log(f"[13] {label}: launches {ran}")
    log(f"[13] {label}: peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    log(f"[13] {label}: wall time {wall:.3f} s")
    if min(ran[k] for k in need) == 0:
        raise AssertionError(f"{label}: launches {ran}; {need} must be above 0")
    return row


def phase13_large_treecodes() -> None:
    """The 2M-10M treecode configurations through ``bh_rollout`` and
    ``treeforce_bench``, each held to its accuracy bar."""
    import torch

    from nbody_tpu_torch.experiments import bh_rollout, treeforce_bench

    a = _large_run("(a) bh_rollout bh2 N=10,000,000 x 16 steps (chunks of 8, refresh 8)",
                   lambda: bh_rollout.main(["--n-bodies", "10000000", *BH2_10M, "--steps", "16",
                                            "--chunk-steps", "8", "--bh-refresh", "8",
                                            "--no-energy-audit", "--error-sample", "4096",
                                            "--device", "cuda"]),
                   ("b1", "b1n", "b9", "b10"))
    log(f"[13] (a) {a['ms_per_step']:.4f} ms/step; sampled force error over "
        f"{a['error_sample']} receivers: median {a['end_rel_err_median']:.4e} (bar "
        f"{BH2_10M_MEDIAN}), p99 {a['end_rel_err_p99']:.4e}")
    if not a["end_rel_err_median"] < BH2_10M_MEDIAN:
        raise AssertionError(f"10M bh2 median force error {a['end_rel_err_median']}")
    (b,) = _large_run("(b) treeforce_bench bh3 N=10,000,000 (tier_rc96 knobs)",
                      lambda: treeforce_bench.main(["--n-bodies", "10000000", *BH3_10M_RC96,
                                                    "--reps", "1", "--error-sample", "4096",
                                                    "--device", "cuda"]),
                      ("b1", "b1n", "b9", "b10"))
    log(f"[13] (b) fresh {b['bh_fresh_ms']:.4f} ms, reused {b['bh_reused_ms']:.4f}, partition "
        f"{b['partition_ms']:.4f}; sampled force error over {b['error_sample']} receivers: "
        f"median {b['rel_err_median']:.4e} (bar {BH3_10M_MEDIAN}), p99 {b['rel_err_p99']:.4e}")
    if not b["rel_err_median"] < BH3_10M_MEDIAN:
        raise AssertionError(f"10M bh3 median force error {b['rel_err_median']}")
    c = _large_run("(c) bh_rollout bh2 N=2,000,000 x 32 steps (exact B2 energy)",
                   lambda: bh_rollout.main(["--n-bodies", "2000000", *BH2_2M, "--steps", "32",
                                            "--device", "cuda"]),
                   ("b1n", "b2", "b9", "b10"))
    log(f"[13] (c) {c['ms_per_step']:.4f} ms/step; energy drift {c['rel_energy_drift']:.3e} "
        f"(bar {BH2_2M_DRIFT})")
    if not c["rel_energy_drift"] < BH2_2M_DRIFT:
        raise AssertionError(f"2M bh2 energy drift {c['rel_energy_drift']}")
    torch.cuda.empty_cache()


def phase13_kernels() -> None:
    """(d) Every launch of a bh2 force evaluation at 10M (B9, B10's three,
    B1's near list with groups of 512 receivers and source blocks of 512)
    against its plain version once, the kernel twice for the same bits."""
    import torch

    from nbody_tpu_torch.ops import treeforce as tf

    pos, mass, part = _tree_shapes(10_000_000, 10_000_009, tf.build_bh2_partition,
                                   BH2_10M_PART, tag="13")
    for case in _two_level_cases(pos, mass, part, BH2_10M_PART):
        _against_plain(*case, tag="13", time_it=False)
    del pos, mass, part
    torch.cuda.empty_cache()


def phase13_tier_paths() -> None:
    """(e) bh3 at 10M at ``bh3_10m_tier.json``'s knobs on ``treeforce_bench``'s
    ICs (seed 0) and receivers (the first 4,096 and 65,536 of its seed-42
    permutation): the kernel path against the dense path, whose plain
    versions stand in for B9, B10 and the near list, on one partition. Each
    element within phase 9b's bar but for ``SEAM_SHARE`` of them, and the
    sampled median and p99 of the force error against the exact sum (B1)
    the same to 1 % on both paths: what the p99 reads at these knobs is
    not the kernels'."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import treeforce as tf

    n, dev = 10_000_000, torch.device("cuda")
    pos, _, mass = generate_spiral(prng.PRNGKey(0), n, device=dev)
    part = tf.build_bh3_partition(pos, mass, **BH3_10M_TIER)
    runs = {impl: tf.bh3_accelerations(pos, mass, G, EPS, partition=part, near_impl=impl)
            for impl in ("kernel", "dense")}
    got, dense = runs["kernel"], runs["dense"]
    n_over = int(((got - dense).abs() > NEAR_ATOL["bh3"] + 2e-3 * dense.abs()).sum())
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(42))[:65_536].to(dev)
    exact = pw.partial_accelerations(pos[idx].contiguous(), pos, mass, G, EPS)
    stats = {}
    for impl, acc in runs.items():
        rel = ((acc[idx] - exact).norm(dim=-1) / (exact.norm(dim=-1) + 1e-30)).double()
        for s in (4096, 65_536):
            stats[impl, s] = (float(rel[:s].median()), float(torch.quantile(rel[:s], 0.99)))
    for s in (4096, 65_536):
        log(f"[13] (e) bh3 N={n} {BH3_10M_TIER}, {s} receivers: median / p99 kernel "
            f"{stats['kernel', s][0]:.6e} / {stats['kernel', s][1]:.6e}, dense "
            f"{stats['dense', s][0]:.6e} / {stats['dense', s][1]:.6e}")
    log(f"[13] (e) elements over rtol 2e-3 + atol {NEAR_ATOL['bh3']}, kernel vs dense: "
        f"{n_over} of {got.numel()}")
    ratios = [stats["kernel", k][i] / stats["dense", k][i] for k in (4096, 65_536)
              for i in (0, 1)]
    if not (n_over <= SEAM_SHARE * got.numel() and max(abs(r - 1) for r in ratios) <= 0.01):
        raise AssertionError(f"10M bh3 kernel path against the dense path: {n_over} over, "
                             f"error ratios {ratios}")
    del pos, mass, part, runs, got, dense, exact
    torch.cuda.empty_cache()


def _script(name: str):
    """``scripts/NAME.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "scripts",
                                                                      name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase15_sweeps(card: str) -> dict:
    """Rows of the JAX package's sub-2M treecode sweeps, kNN recall table and
    crossover study answered through their entry points and held to
    ``scripts/answer_ratios.py``'s bars; returns the launches of each
    artifact's rows."""
    import torch

    runs, ratios = _script("h100_treecode_runs"), _script("answer_ratios")
    launches = {}
    for name, select, need in SWEEP_ROWS:
        torch.cuda.empty_cache()
        zero_counts()
        t0 = time.perf_counter()
        ans = runs.answer(name, card=card, select=select)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = launches[name] = read_counts()
        log(f"[15] {name}: launches {ran}; wall time {wall:.3f} s")
        if min(ran[k] for k in need) == 0 or ran["b6"] or ran["b11"]:
            raise AssertionError(f"{name}: launches {ran}; {need} must be above 0, B6 and "
                                 f"B11 at 0")
        want = runs.jax_artifact(name)
        want = {**want, "rows": [r for r in want["rows"] if select(r)]}
        if ans["device_kind"] != torch.cuda.get_device_name(0) or ans["card"] != card:
            raise AssertionError(f"{name}: answer header {ans}")
        rows = ratios.compare(name, ans, want)
        for r in rows:
            ratio = "-" if r[5] is None else f"{r[5]:.4f}"
            log(f"[15] {name} {r[1]} {r[2]}: JAX {r[3]}, port {r[4]}, port / JAX {ratio}, "
                f"bar {r[6]}: {r[7]}")
        bad = [r for r in rows if r[7] in ("MISSED", "MISSING")]
        barred = [r for r in rows if r[7] == "met"]
        if bad or not barred and not name.startswith("crossover"):
            raise AssertionError(f"{name}: {bad or 'no barred reading'}")
        for r in ans["rows"]:
            if "mode" in r and not (r["finite"] and math.isfinite(r["ms_per_step"])):
                raise AssertionError(f"{name}: {r}")
    return launches


def _b11_case(label, u, vpad, idx, mask, dtype, tile, half, time_it):
    """B11 against its plain version on one input, twice for the same bits;
    returns (max abs err, ms, plain ms, bound)."""
    import torch

    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    kw = dict(tile=tile, half=half, gather_dtype=dtype)
    got, again = (ek.windowed_tanh_sum(u, vpad, idx, mask, **kw) for _ in range(2))
    torch.cuda.synchronize()
    want = ek.windowed_tanh_sum_torch(u, vpad, idx, mask, **kw)
    same = torch.equal(got, again)
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= B11_TOL + B11_TOL * want.abs()).all())
    n, d = u.shape
    edges = float((mask & ek._window_rows(idx, tile, half)).sum())
    # per executed edge and channel an add and a tanhf; u, vpad, idx, mask
    # read once, out written once
    bnd = bound((1.0 + TANH_FLOPS) * edges * d,
                4.0 * (2 * n * d + vpad.numel() + idx.numel()) + mask.numel())
    ms = plain_ms = float("nan")
    if time_it:
        ms = cuda_time_ms(lambda: ek.windowed_tanh_sum(u, vpad, idx, mask, **kw), reps=10,
                          warmup=1)
        plain_ms = cuda_time_ms(lambda: ek.windowed_tanh_sum_torch(u, vpad, idx, mask, **kw),
                                reps=3, warmup=1)
    log(f"[10a] B11 windowed_tanh_sum {label}: max|d| {err:.3e}, within rtol = atol = "
        f"{B11_TOL} {ok}, same bits twice {same}; {edges:.0f} edges in the window; kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]})")
    if not (ok and same and bool(torch.isfinite(got).all())):
        raise AssertionError(f"B11 disagrees with its plain version ({label})")
    return err, ms, plain_ms, bnd


def phase10_kernel():
    """B11 against its plain version; returns the kernels line's numbers
    (1M rows, k = 8, d = 64, float32 gather)."""
    import torch

    from nbody_tpu_torch.experiments import edgeconv_bench as ebench

    dev = torch.device("cuda")
    # odd tile, half and width; edges past the window
    small = ebench.window_case(torch.Generator().manual_seed(23), 3 * 37, 3, 12, 30, 5, dev)
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        _b11_case(f"N=111 k=3 d=12 tile=37 half=5 {dtype}", *small, dtype, 37, 5, False)
    big = ebench.synthetic(TREE_1M, dev)  # 1M rows padded to whole tiles
    n = big[0].shape[0]
    for dtype in (torch.float32, torch.bfloat16):
        nums = _b11_case(f"N={n} k=8 d=64 tile=256 half=384 {dtype}", *big, dtype,
                         WINDOW["tile"], WINDOW["half"], True)
        out = out or nums
    del big
    torch.cuda.empty_cache()
    return out


def _hold_1m_kernels(pos, mass, idx, valid):
    """B7, B8 and B1 against their plain versions at the shapes the 1M entry
    points give them: the select and the merge behind the k = 8 graph of
    ``pos`` (which must be the graph ``idx``, ``valid`` that the path built),
    its recall against the exact search on ``SAMPLE_1M`` receivers, and the
    direct sum of those receivers over all sources."""
    import torch

    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import spatial as sp
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    n, k = idx.shape
    block = 256  # build_graph's default
    order = sp._curve_order(pos, None, 4)
    cand, qg = sp._candidates(pos, order, block)
    ids, d2 = sp.morton_select(cand, k, block, False)
    ids_t, d2_t = sp.morton_select_torch(cand, k, block, False)
    ok7 = torch.equal(ids, ids_t) and torch.allclose(d2, d2_t, rtol=1e-6, atol=0)
    ms7 = cuda_time_ms(lambda: sp.morton_select(cand, k, block, False), reps=5, warmup=1)
    ms7t = cuda_time_ms(lambda: sp.morton_select_torch(cand, k, block, False), reps=1,
                        warmup=0)
    mc, md = sp._to_rows(qg, ids, d2, n)
    m_ids, m_d2 = sp.morton_merge(mc, md, k)
    t_ids, t_d2 = sp.morton_merge_torch(mc, md, k)
    ok8 = torch.equal(m_ids, t_ids) and torch.allclose(m_d2, t_d2, rtol=1e-6, atol=0)
    ms8 = cuda_time_ms(lambda: sp.morton_merge(mc, md, k), reps=5, warmup=1)
    ms8t = cuda_time_ms(lambda: sp.morton_merge_torch(mc, md, k), reps=1, warmup=0)
    # the path's graph is what these two launches give
    bnd7, bnd8 = select_merge_bounds(cand, ids, mc, m_ids, k, block)
    found = m_d2 < sp._BAD_D2
    same = torch.equal(valid, found) and torch.equal(
        idx, torch.where(found, m_ids, 0).clamp(0, n - 1).to(torch.int32))
    log(f"[10b] B7 select N={n} k={k}: ids identical {ok7}, max|dd2| "
        f"{float((d2 - d2_t).abs().max()):.3e}; kernel {ms7:.4f} ms  plain {ms7t:.4f} ms, "
        f"bound {bnd7[0]:.4f} ms ({bnd7[1]})")
    log(f"[10b] B8 merge  N={n} k={k}: ids identical {ok8}, max|dd2| "
        f"{float((m_d2 - t_d2).abs().max()):.3e}; kernel {ms8:.4f} ms  plain {ms8t:.4f} ms; "
        f"bound {bnd8[0]:.4f} ms ({bnd8[1]}); the path's graph equals these launches' {same}")
    del cand, ids, d2, ids_t, d2_t, mc, md, t_ids, t_d2

    rows = torch.randperm(n, generator=torch.Generator().manual_seed(42))[:SAMPLE_1M]
    rows = rows.to(pos.device)
    hits = 0
    for r in rows.split(128):  # exact differences, (128, N) at a time
        qr = pos[r]
        dd = sum((pos[None, :, a] - qr[:, a, None]) ** 2 for a in range(3))
        dd[torch.arange(r.shape[0], device=r.device), r] = float("inf")
        exact = torch.topk(dd, k, dim=1, largest=False).indices
        got = torch.where(valid[r], idx[r].long(), -1)
        hits += int((got[:, :, None] == exact[:, None, :]).any(1).sum())
    recall = hits / (rows.shape[0] * k)

    q = pos[rows].contiguous()

    def plain(dtype):  # the plain version, 128 receivers at a time
        p, m = pos.to(dtype), mass.to(dtype)
        return torch.cat([pw.partial_accelerations_torch(p[r], p, m, G, EPS)
                          for r in rows.split(128)])

    acc = pw.partial_accelerations(q, pos, mass, G, EPS)
    same1 = torch.equal(acc, pw.partial_accelerations(q, pos, mass, G, EPS))
    acc_t, acc_d = plain(torch.float32), plain(torch.float64)
    top = float(acc_d.abs().max())
    rel1, rel1_d, relt_d = (float((a - b).abs().max()) / top for a, b in
                            ((acc, acc_t), (acc, acc_d), (acc_t, acc_d)))
    ms1 = cuda_time_ms(lambda: pw.partial_accelerations(q, pos, mass, G, EPS), reps=5,
                       warmup=1)
    bnd1 = bound(*pw.force_work(q.shape[0], n))
    log(f"[10b] knn_morton(kernel) N={n} k={k}: recall vs exact on {rows.shape[0]} receivers "
        f"{recall:.5f} (bar {RECALL})")
    log(f"[10b] B1 force {q.shape[0]} x {n}: max|da|/max|a| against the plain version "
        f"{rel1:.3e}, against its float64 run {rel1_d:.3e} (bar {B1_TOL} each; the plain "
        f"version against float64 {relt_d:.3e}), same bits twice {same1}; kernel {ms1:.4f} "
        f"ms, bound {bnd1[0]:.4f} ms ({bnd1[1]})")
    if not (ok7 and ok8 and same and recall >= RECALL and max(rel1, rel1_d) <= B1_TOL
            and same1):
        raise AssertionError(f"a kernel of the 1M path disagrees with its plain version at "
                             f"N={n}: B7 {ok7}, B8 {ok8}, graph {same}, recall {recall}, "
                             f"B1 {rel1} / {rel1_d}, same bits {same1}")


def phase10_path_data() -> int:
    """``edge_message_sum`` on the crossover path's own data at 1M bodies;
    returns B11's launches."""
    import torch

    from nbody_tpu_torch.experiments import edgeconv_bench as ebench
    from nbody_tpu_torch.ops import edgeconv_kernel as ek
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    n = TREE_1M
    pos, mass, u, v, idx, valid = ebench.path_data(n, torch.device("cuda"))
    _hold_1m_kernels(pos, mass, idx, valid)

    want = ebench.gather_sum(u, v, idx, valid)
    plan = ek.plan_windowed_gather(idx, valid, **WINDOW)
    torch.cuda.synchronize()
    share = float(plan.in_mask.sum()) / float(valid.sum())
    overflow, fallback = int(plan.overflow), int(plan.fb_valid.sum())
    ek.windowed_tanh_sum.launches = 0
    got = ek.edge_message_sum(u, v, idx, plan, **WINDOW)
    again = ek.edge_message_sum(u, v, idx, plan, **WINDOW)
    torch.cuda.synchronize()
    launches = ek.windowed_tanh_sum.launches
    rel = float((got - want).abs().max()) / float(want.abs().max())
    same = torch.equal(got, again)
    plain = ek.edge_message_sum_torch(u, v, idx, plan, **WINDOW)  # B11's owned mode, plain
    err = float((got - plain).abs().max())
    ok_plain = bool(((got - plain).abs() <= B11_TOL + B11_TOL * plain.abs()).all())
    del plain
    up, vpad, idxp = ebench.window_inputs(u, v, idx, plan)  # B11 alone
    ms_plan = cuda_time_ms(lambda: ek.plan_windowed_gather(idx, valid, **WINDOW), reps=3,
                           warmup=1)
    ms_gather = cuda_time_ms(lambda: ebench.gather_sum(u, v, idx, valid), reps=5, warmup=1)
    ms_b11 = cuda_time_ms(lambda: ek.windowed_tanh_sum(up, vpad, idxp, plan.in_mask, **WINDOW),
                          reps=10, warmup=1)
    ms_all = cuda_time_ms(lambda: ek.edge_message_sum(u, v, idx, plan, **WINDOW), reps=10,
                          warmup=1)
    log(f"[10b] EdgeConv_0 of the 1M model on Morton-sorted spiral bodies, N={n} k=8 d=64: "
        f"in-window share {share:.4f} of {int(valid.sum())} valid edges, fallback list "
        f"{fallback} of {plan.fb_valid.numel()} slots, overflow {overflow}; "
        f"edge_message_sum vs the layer's masked tanh sum max|d|/max {rel:.3e} (bar 1e-5), "
        f"vs its plain version max|d| {err:.3e} (within rtol = atol = {B11_TOL} {ok_plain}), "
        f"same bits twice {same}; B11 launches {launches}")
    log(f"[10b] ms per message sum: torch gather + tanh + sum {ms_gather:.4f}, B11 alone "
        f"on the in-window edges {ms_b11:.4f}, edge_message_sum (one B11 launch) "
        f"{ms_all:.4f}; the plan (once per graph build) {ms_plan:.4f}")
    if not (overflow == 0 and fallback > 0 and rel <= 1e-5 and same and launches == 2
            and ok_plain):
        raise AssertionError("edge_message_sum disagrees with the fused layer's sum or its "
                             "plain version, dropped edges, or never launched B11")
    torch.cuda.empty_cache()
    return launches


def phase10_fused_forward():
    """Fused against unfused ``GraphModel`` forward at 100k, same graph."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(prng.PRNGKey(0), LARGE_N, device=dev)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    outs, peaks, times = [], [], []
    idx = valid = None
    for fused in (False, True):
        model = GraphModel(**GNN_1M, fused_edgeconv=fused)
        model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
        model.to(dev).eval()
        with torch.no_grad():
            if idx is None:
                idx, valid = build_graph(model.graph_spec, pos[None])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs.append(model(x, idx, valid))
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 20)
            times.append(cuda_time_ms(lambda: model(x, idx, valid), reps=10, warmup=1))
    ref = outs[0]
    scale = float(ref.abs().max())
    d_max = float((outs[1] - ref).abs().max())
    log(f"[10c] GraphModel forward N={LARGE_N} k=8, fused vs unfused on one graph: max|da| "
        f"{d_max:.3e}, max|a| {scale:.3e}; unfused {times[0]:.4f} ms, peak {peaks[0]:.1f} MiB "
        f"above the inputs; fused {times[1]:.4f} ms, peak {peaks[1]:.1f} MiB")
    if not torch.allclose(outs[1], ref, rtol=MODEL_RTOL, atol=MODEL_ATOL * scale):
        raise AssertionError("the fused EdgeConv forward disagrees with the unfused one")


def phase10_crossover(tmp: str) -> dict:
    """``crossover`` through its ``main``; returns the launches of those two
    calls alone (the profiled rollout after them builds its own model)."""
    from nbody_tpu_torch.experiments import crossover

    common = ["--neighbors", "8", "--graph-refresh", "1", "8", "--steps", "10",
              "--load-params", PARAMS_1M, "--device", "cuda"]
    out = os.path.join(tmp, "crossover.json")
    zero_counts()
    rows = crossover.main(["--n-bodies", str(LARGE_N), "--bh", "--bh2", "--bh3", "--out", out,
                           *common])
    rows += crossover.main(["--n-bodies", str(TREE_1M), "--only", "direct", "bh3", "surrogate",
                            "--n-sub", str(BH3_1M["n_sub"]), "--out", out, *common])
    ran = entry_point_counts("crossover at 100k and 1M", ("b1", "b7", "b8", "b9", "b10", "b1n"))
    with open(out) as f:
        art = json.load(f)
    if (len(rows) != 6 + 4 or len(art["rows"]) != len(rows) or art["device"] != "gpu"
            or art["steps"] != 10):
        raise AssertionError(f"crossover: {len(rows)} rows, artifact {art}")
    for r in rows:
        if not (set(r) >= {"n", "mode", "ms_per_step", "psteps_per_s"}
                and math.isfinite(r["ms_per_step"]) and r["psteps_per_s"] > 0
                and (("params" in r) == r["mode"].startswith("surrogate"))):
            raise AssertionError(f"crossover row {r}")
        log(f"[10d] crossover N={r['n']} {r['mode']}: {r['ms_per_step']:.4f} ms/step")
    _profile_1m_rollout()
    return ran


def _profile_1m_rollout(steps: int = 10, refresh: int = 8):
    """Wall and device time of one more 1M surrogate rollout as crossover
    runs it (trained weights, fused EdgeConv, Morton kernels)."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.utils import prng
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.train import autoregressive_rollout
    from nbody_tpu_torch.utils.timing import device_time, profile_ms

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(prng.PRNGKey(0), TREE_1M, device=dev)
    model = GraphModel(**GNN_1M, fused_edgeconv=True)
    model.load_state_dict(torch.load(PARAMS_1M, map_location="cpu", weights_only=True))
    model.to(dev).eval()

    def run():
        autoregressive_rollout(model, pos, vel, mass, steps + 1, DT, graph_refresh=refresh)

    run()
    _, wall = device_time(run, dev)
    busy_ms, top = profile_ms(run, dev)
    log(f"[10d] 1M surrogate rollout (refresh {refresh}), one more {steps}-step run: "
        f"{1e3 * wall / steps:.4f} ms/step wall, {busy_ms / steps:.4f} ms/step device, idle "
        f"share {1.0 - busy_ms / 1e3 / wall:.4f}, top device rows (ms/step) "
        f"{_rows([(n, t / steps) for n, t in top])}")


def _train_large(argv, label, steps_per_epoch, need, tag="10e"):
    """One ``train_large.main`` call with the launch counts at 0 before it;
    logs ms per optimiser step of its last epoch and the call's peak memory,
    returns the result and the call's launches (``need`` above 0)."""
    import torch

    from nbody_tpu_torch.experiments import train_large

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = train_large.main([*argv, "--device", "cuda"])
    wall = time.perf_counter() - t0
    ran = entry_point_counts(f"train_large {label}", need)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"stepwise_scaled_rmse", "predict_zero_baseline_scaled_rmse", "rollout_horizon",
            "rollout_seconds", "rollout_pos_rmse", "final_acc_median_rel_err_vs_exact",
            "final_acc_rmse_vs_exact", "final_acc_rel_rmse_vs_exact"}
    ev = res["eval"]
    if not (set(res) >= {"n_bodies", "model", "device", "dataset", "training", "eval"}
            and set(ev) >= want and res["device"] == "gpu" and ev["rollout_pos_rmse"]
            and all(math.isfinite(ev[k]) for k in want - {"rollout_pos_rmse"})
            and all(math.isfinite(r["pos_rmse"]) for r in ev["rollout_pos_rmse"])):
        raise AssertionError(f"train_large {label}: result {res}")
    per_epoch = res["training"]["seconds_per_epoch"]
    step_ms = 1e3 * per_epoch[-1] / steps_per_epoch if per_epoch else float("nan")
    log(f"[{tag}] train_large {label}: {wall:.2f} s wall, datagen "
        f"{res['dataset']['datagen_seconds']} s, last epoch {step_ms:.4f} ms per optimiser "
        f"step, losses first {res['training']['first_scaled_rmse']} final "
        f"{res['training']['final_scaled_rmse']}; stepwise {ev['stepwise_scaled_rmse']:.6g} "
        f"(zero baseline {ev['predict_zero_baseline_scaled_rmse']:.6g}), final acc rel RMSE "
        f"vs exact {ev['final_acc_rel_rmse_vs_exact']:.4g}; peak memory {peak:.3f} GiB")
    return res, ran


@contextlib.contextmanager
def _training_forwards():
    """Each forward in training mode of the models that ``train_large`` builds
    meanwhile, as (the launch counts so far, the largest |prediction|) in
    order, in the list this yields."""
    from nbody_tpu_torch.experiments import train_large

    seen, build = [], train_large.build_model

    def hook(model, _inputs, out):
        if model.training:
            seen.append((read_counts(), float(out.detach().abs().max())))

    def build_and_hook(*a, **kw):
        model = build(*a, **kw)
        model.register_forward_hook(hook)
        return model

    train_large.build_model = build_and_hook
    try:
        yield seen
    finally:
        train_large.build_model = build


def _large_step_numbers(argv, data_dir, label, steps, tag="10e"):
    """A warm and a profiled epoch of ``train_large``'s own model and trainer on
    its dataset: ms per optimiser step, idle share, top rows and
    the peak memory of those epochs."""
    import torch

    from nbody_tpu_torch.experiments import train_large
    from nbody_tpu_torch.train import PlateauScheduler, Trainer

    dev = torch.device("cuda")
    args = train_large.build_parser().parse_args(argv)
    trainer = Trainer(train_large.build_model(args, dev).to(dev), learning_rate=args.lr, dt=DT,
                      scheduler=PlateauScheduler(lr=args.lr, factor=0.25, patience=5))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms, idle, top = _epoch_numbers(trainer, data_dir, args.batch_size, steps,
                                   batch_mode="bucketed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] train step {label}: {ms:.4f} ms per optimiser step, idle share {idle:.4f}, "
        f"peak memory {peak:.3f} GiB, top device rows {_rows(top)}")
    del trainer
    torch.cuda.empty_cache()


def phase10_train_large(tmp: str) -> dict:
    """``train_large`` through its ``main``: the 1M GNN with remat, resume
    and an eval-only rerun; the 100k ContConv chunked and unchunked. Returns
    the launches of those ``main`` calls alone (the step profiles between
    them build their own trainer)."""
    import pandas as pd

    graph = ("b1", "b7", "b8")  # the exact-force check and every Morton graph build
    datagen = ("b9", "b1n")     # the bh ground truth
    total = dict.fromkeys(kernel_wrappers(), 0)

    def run(argv, label, need):
        res, ran = _train_large(argv, label, snaps, need)
        for name, c in ran.items():
            total[name] += c
        return res, ran

    data = os.path.join(tmp, "data")
    out = os.path.join(tmp, "train_1m.json")
    snaps = 2  # steps 0 and 4 of an 8-step scene
    gnn = ["--n-bodies", str(TREE_1M), "--neighbors", "8", "--remat", "--batch-size", "1",
           "--graph-refresh", "8", "--train-scenes", "1", "--steps", "8", "--stride", "4",
           "--save-every", "1", "--data-dir", data, "--out", out]
    first, _ = run([*gnn, "--epochs", "2"], "GNN N=1M k=8 remat, 2 epochs", graph + datagen)
    again, _ = run([*gnn, "--epochs", "1", "--skip-datagen"], "GNN N=1M resumed, 1 more epoch",
                   graph)
    loss = pd.read_csv(out[:-5] + "_epoch_loss.csv")
    ckpts = sorted(os.listdir(out[:-5] + "_ckpt"))
    if (list(loss["epoch"]) != [1, 2, 3] or ckpts != ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
            or not all(math.isfinite(v) for v in loss["loss"])
            or len(first["training"]["seconds_per_epoch"]) != 2
            or len(again["training"]["seconds_per_epoch"]) != 1):
        raise AssertionError(f"1M resume: epochs {list(loss['epoch'])}, checkpoints {ckpts}")
    ev, _ = run([*gnn, "--skip-datagen", "--load-params", out[:-5] + "_params.pt"],
                "GNN N=1M eval only from the saved weights", graph)
    if (ev["eval"].get("params_loaded_from") != out[:-5] + "_params.pt"
            or ev["training"] != again["training"]
            or not math.isclose(ev["eval"]["stepwise_scaled_rmse"],
                                again["eval"]["stepwise_scaled_rmse"], rel_tol=1e-6)):
        raise AssertionError("the eval-only rerun does not repeat the resumed run's eval")
    _large_step_numbers(gnn, os.path.join(data + "1000k", "train"),
                        "GNN N=1M k=8 fused, remat, batch 1", snaps)

    conv = ["--model", "contconv", "--n-bodies", str(LARGE_N), "--batch-size", "1",
            "--train-scenes", "1", "--steps", "8", "--stride", "4", "--epochs", "2",
            "--data-dir", data]
    layers, epochs = 2, 2
    for chunks, extra, need in ((CHUNKS, [], datagen), (1, ["--skip-datagen"], ())):
        res, ran = run([*conv, *extra, "--conv-node-chunks", str(chunks), "--out",
                        os.path.join(tmp, f"train_100k_c{chunks}.json")],
                       f"ContConv N=100k, {chunks} node chunk(s)",
                       graph + ("b3", "b4", "b5") + need)
        counts = [ran[name] for name in ("b3", "b4", "b5", "b6")]
        train = chunks * layers * snaps * epochs
        # each chunk's forward runs again in the backward when it is
        # checkpointed; the eval's forwards: 2 stepwise, horizon + 1 rollout
        fwd = (2 if chunks > 1 else 1) * train + \
            (snaps + res["eval"]["rollout_horizon"] + 1) * layers * chunks
        log(f"[10e] ContConv N=100k, {chunks} chunk(s): launches B3 {counts[0]} (expected "
            f"{fwd}), B4 {counts[1]}, B5 {counts[2]} (expected {train} each), B6 {counts[3]}")
        if counts != [fwd, train, train, 0]:
            raise AssertionError(f"ContConv launches {counts} with {chunks} chunk(s)")
        _large_step_numbers([*conv, "--conv-node-chunks", str(chunks)],
                            os.path.join(data + "100k", "train"),
                            f"ContConv N=100k, batch 1, {chunks} node chunk(s)", snaps)
    return total


def phase10_knn_recall():
    from nbody_tpu_torch.experiments import knn_recall

    rows = knn_recall.main(["--n-bodies", str(LARGE_N), "--windows", "64", "--kernel-blocks",
                            "256", "--device", "cuda"])
    for r in rows:
        log(f"[10f] knn_recall {r['profile']} N={r['n']} k={r['k']} {r['method']}: "
            f"{1e3 * r['seconds']:.4f} ms, recall {r['recall']:.5f}")
    kernel = [r for r in rows if r["method"].startswith("morton-kernel")]
    exact = [r for r in rows if r["method"] in ("exact", "approx")]
    if (len(rows) != 8 or len(kernel) != 2 or min(r["recall"] for r in kernel) < RECALL
            or len(exact) != 4 or any(r["recall"] != 1.0 for r in exact)):
        raise AssertionError(f"knn_recall: {rows}")


def phase10_knn_approx():
    """``approx`` kNN (the JAX package's ``lax.approx_max_k`` as XLA computes it
    off the TPU) on the card: at BIG_N bodies of a spiral, masked, the exact
    selection's ids and validity; then a reference-width
    ``GraphModel(knn_method="approx")`` takes one rollout step on those bodies."""
    import torch

    from nbody_tpu_torch.ics import generate_spiral
    from nbody_tpu_torch.models import GraphModel
    from nbody_tpu_torch.ops.knn import knn_neighbors
    from nbody_tpu_torch.train import autoregressive_rollout
    from nbody_tpu_torch.utils import prng

    dev = torch.device("cuda")
    pos, vel, mass = generate_spiral(prng.PRNGKey(7), BIG_N, device=dev)
    mask = torch.arange(BIG_N, device=dev) % 10 != 3
    a = knn_neighbors(pos, 10, mask=mask, approx=True)
    e = knn_neighbors(pos, 10, mask=mask)
    if not (torch.equal(a[0], e[0]) and torch.equal(a[1], e[1])):
        raise AssertionError(f"approx kNN at {BIG_N} is not the exact selection")
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=10, scale_factor=1e6, knn_method="approx",
                       key=prng.PRNGKey(0)).to(dev).eval()
    ps, vs, accs = autoregressive_rollout(model, pos, vel, mass, 2, DT)
    if any(t.shape != (2, BIG_N, 3) or not bool(torch.isfinite(t).all())
           for t in (ps, vs, accs)):
        raise AssertionError("approx GraphModel rollout step")
    log(f"[10f] approx kNN at N={BIG_N}: the exact ids and validity (masked); "
        f"GraphModel(knn_method='approx') took one rollout step, finite")


def parallel_spec(train_dir: str, small: bool) -> dict:
    """Phase 11's sizes for ``parallel.dryrun.check_paths``: the ring, bh (with
    a 16-step rollout, refresh 8) and the GNN rollout with the committed 1M
    weights at 100,000 bodies, one bh3 force evaluation at 1,000,000, the
    full-width ``contconv_adopted.json`` model at 20,000 (its random initial
    head is not zero here, and its radius graph is the Morton search, so the
    replicated graph is the single-rank one bit for bit) and
    ``Trainer(mesh=)`` on phase 8a's recipe cut (``train_dir``), every step
    held from the same parameters; ``small``: the NCCL world-1 run's sizes,
    its free-running epoch losses held too (world size 1 sums as one process
    does)."""
    cfg = os.path.join(HERE, "configs", "contconv_adopted.json")
    n = PAR_SMALL_N if small else PAR_N
    return {
        "reps": 2,
        "ring": {"n": n, "backend": "kernel", "dt": DT},
        "bh": {"n": n, "steps": 16, "refresh": 8, "bh": BH_100K, "bh2": BH2_100K,
               "bh3": BH3_1M, "bh3_n": PAR_N if small else PAR_1M},
        "gnn": {"n": n, "steps": 3, "dt": DT, "kwargs": dict(GNN_1M, fused_edgeconv=True),
                "weights": PARAMS_1M},
        "contconv": {"n": PAR_SMALL_CC_N if small else PAR_CC_N, "config": cfg,
                     "overrides": ["model.kwargs.zero_init_output=false",
                                   "model.kwargs.radius_method=morton",
                                   "model.kwargs.radius_impl=kernel"]},
        "train": {"dir": train_dir, "config": cfg, "epochs": 1, "batch_size": 16,
                  "lr": 1e-3, "batch_mode": "mixed", "merge_files": True,
                  "hold_epochs": small},
    }


def _parallel_lines(label: str, out: dict, card: str) -> None:
    """ms a step of the sharded run and of the one-process run, by path."""
    ring, bh, gnn, cc, tr = (out[k] for k in ("ring", "bh", "gnn", "contconv", "train"))
    rows = [("ring force (B1 hops)", ring["acc"]["ms"], ring["acc"]["single_ms"]),
            ("ring energies (B2)", ring["energies"]["ms"], ring["energies"]["single_ms"]),
            *((f"sharded {e} force, N={bh[e]['n']}", bh[e]["ms"], bh[e]["single_ms"])
              for e in ("bh", "bh2", "bh3")),
            ("bh rollout step", bh["bh_simulate"]["ms_per_step"],
             bh["bh_simulate"]["single_ms_per_step"]),
            (f"GNN rollout step, N={gnn['n']}", gnn["ms_per_step"], gnn["single_ms_per_step"]),
            (f"ContConv predict, N={cc['predict']['n']}", cc["predict"]["ms"],
             cc["predict"]["single_ms"]),
            ("ContConv loss and grad", cc["loss"]["ms"], cc["loss"]["single_ms"]),
            ("DP training epoch", 1e3 * tr["s_per_epoch"], 1e3 * tr["single_s_per_epoch"])]
    for name, ms, ms1 in rows:
        log(f"[11] {label} {name}: {ms:.4f} ms sharded, {ms1:.4f} ms in one process "
            f"({card})")
    bits = {e: bh[e]["bits_equal"] for e in ("bh", "bh2", "bh3")}
    log(f"[11] {label}: treecode bits equal to one process {bits} (even blocks "
        f"{ {e: bh[e]['even'] for e in bits} }); ring |da|/max|a| {ring['acc']['max_abs_err']:.3e}, "
        f"GNN rollout max |d acc| {gnn['acc']['max_abs_err']:.3e}, ContConv predict "
        f"{cc['predict']['max_abs_err']:.3e}, loss {cc['loss']['max_abs_err']:.3e}, "
        f"grads {cc['grads']['max_abs_err']:.3e}; DP steps from the same parameters: "
        f"{tr['steps']} losses (max |d| {tr['max_abs_err']:.3e}) and gradients (max |d|/max "
        f"{tr['grads_max_abs_err']:.3e}) within rtol 2e-4; free-running epoch losses "
        f"{tr['losses']} vs {tr['single_losses']} (rel {tr['epoch_rel_diff']:.3e}; one "
        f"process from weights one ulp up: {tr['ulp_losses']}, rel "
        f"{tr['ulp_epoch_rel_diff']:.3e}); "
        f"wall s by path "
        f"{ {k: round(out[k + '_wall_s'], 2) for k in ('ring', 'bh', 'gnn', 'contconv', 'train')} }")


def phase11_parallel(tmp: str, card: str) -> dict:
    """``parallel/`` on the card: every sharded path of
    ``parallel.dryrun.check_paths`` on 2 ranks on cuda:0 over gloo (NCCL
    refuses two ranks on one device; gloo moves the tensors through host
    memory, so the 2-rank times measure that overhead, not scaling), then at
    world size 1 over NCCL, each held by rank 0 to the one-process result at
    the JAX tests' bars. Returns the 2-rank run's kernel launches, counted
    in rank 0 over its sharded calls only."""
    import random

    import torch

    from nbody_tpu_torch.config import ExperimentConfig
    from nbody_tpu_torch.data.generate import generate_dataset
    from nbody_tpu_torch.parallel import dryrun
    from nbody_tpu_torch.parallel.launch import run_ranks

    cfg = ExperimentConfig.load(os.path.join(HERE, "configs", "contconv_adopted.json"))
    cfg = cfg.apply_overrides(RUN_SETS)
    rng = random.Random(cfg.datagen.seed)
    full, first = os.path.join(tmp, "cut"), os.path.join(tmp, "first_file")
    os.makedirs(full)
    os.makedirs(first)
    for i in range(1, cfg.datagen.train_files + 1):  # phase 8a's recipe cut
        generate_dataset(cfg.scenarios(seed=rng.randint(0, 1000)),
                         os.path.join(full, f"output_file_{i}.csv"), write_csv_file=False,
                         verbose=False, device="cuda")
    # the world-1 run trains on the cut's first file (its npz) alone
    os.symlink(os.path.join(full, "output_file_1.npz"), os.path.join(first, "f1.npz"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = run_ranks(dryrun.check_paths, 2, "gloo", parallel_spec(full, False),
                    device="cuda:0", timeout=600)
    log(f"[11] 2 ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s wall")
    _parallel_lines("2 ranks, gloo", two, card)
    t0 = time.perf_counter()
    one = run_ranks(dryrun.check_paths, 1, "nccl", parallel_spec(first, True),
                    device="cuda:0", timeout=600)
    log(f"[11] world size 1 over NCCL: {time.perf_counter() - t0:.1f} s wall")
    _parallel_lines("world 1, NCCL", one, card)
    for run in (two, one):
        if not run["device"].startswith("cuda") or run["backend"] not in ("gloo", "nccl"):
            raise AssertionError(f"phase 11 ran on {run['device']} over {run['backend']}")
    launches = two["launches"]
    log(f"[11] launches on the sharded paths (rank 0 of 2): {launches}; world 1: "
        f"{one['launches']}")
    if min(launches[k] for k in PAR_NEED) == 0 or launches["b6"] != 0:
        raise AssertionError(f"sharded paths' launches {launches}: {PAR_NEED} above 0, "
                             "B6 at 0 expected")
    return launches


def _reference_step_parts(trainer, train_dir: str, batch_size: int, reps: int = 5):
    """One ``batch_mode="reference"`` optimiser step of the first file: a
    quota of snapshots from each body-count bucket. Device ms of its exact
    kNN graphs (one a snapshot) and of the model's forward and backward on
    them, each profiled alone over ``reps`` calls; returns (graphs, kNN ms,
    model ms, the model's top rows)."""
    import torch

    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.train.trainer import _list_dataset_files
    from nbody_tpu_torch.utils.timing import profile_ms

    dev = trainer.device
    buckets = trainer._device_buckets(_list_dataset_files(train_dir)[:1])
    sizes = {n: b[0].shape[0] for n, b in buckets.items()}
    steps = -(-sum(sizes.values()) // batch_size)
    parts = []
    for n in sorted(buckets):
        q = -(-sizes[n] // steps)
        parts.append(trainer._gather(buckets[n], torch.arange(q, device=dev),
                                     torch.ones(q, dtype=torch.bool, device=dev)))
    spec = trainer.model.graph_spec

    def graphs():
        return [build_graph(spec, x[..., :3], mask) for x, _, mask in parts]

    built = graphs()

    def model_step():
        trainer.model.zero_grad(set_to_none=True)
        sse = sum(((trainer.model(x, idx, valid, node_mask=mask) - y) ** 2
                   * mask[..., None]).sum()
                  for (x, y, mask), (idx, valid) in zip(parts, built))
        sse.backward()

    model_step()
    knn_ms, _ = profile_ms(lambda: [graphs() for _ in range(reps)], dev)
    model_ms, top = profile_ms(lambda: [model_step() for _ in range(reps)], dev, top=8)
    return (sum(x.shape[0] for x, _, _ in parts), knn_ms / reps, model_ms / reps,
            [(name, t / reps) for name, t in top])


def phase14_training_configs(tmp: str) -> dict:
    """The training configurations at full width: (a) the GNN and (b) the
    ContConv recipe steps on the recipe cut, (c) ``train_large``'s 100k GNN.
    The counters are set to 0 here and read at the end; returns them."""
    import torch

    from nbody_tpu_torch.config import ExperimentConfig
    from nbody_tpu_torch.experiments.common import generate_data
    from nbody_tpu_torch.ops import contconv_kernel as cck
    from nbody_tpu_torch.train import Trainer
    from nbody_tpu_torch.train.trainer import _list_dataset_files
    from nbody_tpu_torch.utils.timing import device_time

    dev = torch.device("cuda")
    zero_counts()
    train_dir = os.path.join(tmp, "recipe", "train")
    window_dir = os.path.join(tmp, "window", "train")
    t0 = time.perf_counter()
    generate_data(train_dir, num_files=TRAIN_CUT_FILES, steps=RECIPE_STEPS, seed=42, device=dev)
    generate_data(window_dir, num_files=1, steps=WINDOW_STEPS, seed=42, device=dev)
    log(f"[14] recipe cut: {TRAIN_CUT_FILES} files of {len(RECIPE_N)} scenes x "
        f"{RECIPE_STEPS} steps, and a window of 1 file x {WINDOW_STEPS} steps, in "
        f"{time.perf_counter() - t0:.2f} s")

    def trainer_of(name):
        """The config's model and trainer as its drivers build them: the
        trainer draws JAX's initial weights on the card at first use, from
        ``split(PRNGKey(train.seed))[1]``."""
        cfg = ExperimentConfig.load(os.path.join(HERE, "configs", name))
        model = cfg.build_model().to(dev)
        return cfg, Trainer(model, learning_rate=cfg.train.learning_rate, dt=cfg.train.dt,
                            seed=cfg.train.seed)

    def steps_of(trainer, data_dir, bs, merged):
        """Optimiser steps of one epoch: a file a group (``reference``) or
        every file merged into one pool (``mixed``)."""
        snaps = [trainer._dataset(f).n_snapshots for f in _list_dataset_files(data_dir)]
        return -(-sum(snaps) // bs) if merged else sum(-(-n // bs) for n in snaps)

    def recipe_numbers(cfg, trainer):
        """ms per optimiser step of one epoch of the recipe cut, and the idle
        share and top device rows (ms a step) of the window's epochs (warm,
        timed, profiled: a whole epoch of the cut is too many events for the
        profiler); returns them and the steps of both."""
        bs, merged = cfg.train.batch_size, cfg.train.merge_files
        w_steps = steps_of(trainer, window_dir, bs, merged)
        _, idle, top = _epoch_numbers(trainer, window_dir, bs, w_steps,
                                      batch_mode=cfg.train.batch_mode, merge_files=merged)
        steps = steps_of(trainer, train_dir, bs, merged)
        (losses, _), sec = device_time(lambda: trainer.train_from_dir(
            train_dir, epochs=1, batch_size=bs, verbose=False, merge_files=merged,
            batch_mode=cfg.train.batch_mode), dev)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite training loss {losses}")
        return 1e3 * sec / steps, idle, top, steps, w_steps

    # (a) the GNN recipe step: a step takes a quota of every bucket of a file
    cfg, trainer = trainer_of("gnn_reference.json")
    bs = cfg.train.batch_size
    ms, idle, top, steps, w_steps = recipe_numbers(cfg, trainer)
    graphs, knn_ms, model_ms, model_top = _reference_step_parts(trainer, train_dir, bs)
    log(f"[14a] GNN recipe step (gnn_reference.json: width {cfg.model.kwargs['gnn_dim']}, "
        f"k {cfg.model.kwargs['neighbors']}, batch {bs}, {cfg.train.batch_mode}, exact kNN): "
        f"{ms:.4f} ms per optimiser step over an epoch of {steps} steps; idle share "
        f"{idle:.4f} and top device rows over the window's {w_steps} {_rows(top)}")
    log(f"[14a] one step's parts: {graphs} exact kNN graphs {knn_ms:.4f} device ms, the "
        f"model's forward and backward on them {model_ms:.4f} device ms (top rows "
        f"{_rows(model_top)})")
    if not all(math.isfinite(v) for v in (ms, knn_ms, model_ms)) or graphs < bs:
        raise AssertionError(f"GNN recipe step: {ms}, {knn_ms}, {model_ms}, {graphs} graphs")
    del trainer

    # (b) the ContConv recipe step: B3-B5 launch twice a step, one a layer
    cfg, trainer = trainer_of("contconv_adopted.json")
    bs = cfg.train.batch_size
    wrappers = (cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom)
    before = [w.launches for w in wrappers]
    ms, idle, top, steps, w_steps = recipe_numbers(cfg, trainer)
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    run = cfg.model.kwargs["continuous_conv_layers"] * (steps + 3 * w_steps)
    log(f"[14b] ContConv recipe step (contconv_adopted.json: batch {bs}, "
        f"{cfg.train.batch_mode}, merged): {ms:.4f} ms per optimiser step over an epoch of "
        f"{steps} steps; idle share {idle:.4f} and top device rows over the window's "
        f"{w_steps} {_rows(top)}; launches over the epoch and the window's 3 B3 {counts[0]}, "
        f"B4 {counts[1]}, B5 {counts[2]}, B6 {counts[3]}")
    if counts != [run] * 3 + [0]:
        raise AssertionError(f"ContConv recipe launches B3-B6 {counts}: {run} each for B3-B5 "
                             f"and 0 for B6 expected")
    del trainer
    torch.cuda.synchronize()
    ran = read_counts()  # _train_large sets the counters to 0 again

    # (c) train_large's GNN at 100k through its main, at train_20k's command
    # line as the answer runner builds it, cut to size
    runs = _script("h100_treecode_runs")
    cut = runs.with_flags(runs.train_argv("train_20k"), TRAIN_LARGE_CUT)
    data = ["--data-dir", os.path.join(tmp, "data")]
    with _training_forwards() as fwd:
        res, large = _train_large([*cut, *data, "--out", os.path.join(tmp, "train_100k.json")],
                                  "GNN N=100k, 1 scene of 40 steps, 2 epochs", 10,
                                  ("b1", "b7", "b8", "b9", "b10", "b1n"), tag="14c")
    tr, ev = res["training"], res["eval"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _large_step_numbers(cut, os.path.join(tmp, f"data{LARGE_N // 1000}k", "train"),
                        f"GNN N={LARGE_N} k=10 fused, batch 1", 10, tag="14c")
    # train_20k's line carries --zero-init-output (the runner's EXTRA); the cut
    # once more with it, 1 epoch on the same data: in both runs the first
    # prediction is exactly zero before any step, and a step builds its graph
    # with the same launches
    zero = runs.with_flags(cut, ["--epochs", "1", "--zero-init-output", "--skip-datagen"])
    with _training_forwards() as fwd0:
        _, large0 = _train_large([*zero, *data, "--out", os.path.join(tmp, "train_100k_zero.json")],
                                 "GNN N=100k zero-init output, 1 epoch", 10, ("b1", "b7", "b8"),
                                 tag="14c")
    # launches from the first training forward to the last, a step
    per_step = [{k: (f[-1][0][k] - f[0][0][k]) / (len(f) - 1) for k in ("b7", "b8")}
                for f in (fwd, fwd0)]
    log(f"[14c] zero-init output: first prediction's largest |value| {fwd0[0][1]} (2-epoch "
        f"run {fwd[0][1]}), B7 and B8 launches a training step {per_step[1]} (2-epoch run "
        f"{per_step[0]}); forwards {len(fwd0)} and {len(fwd)}")
    if "--zero-init-output" not in cut or fwd0[0][1] != 0.0 or fwd[0][1] != 0.0 \
            or per_step[0] != per_step[1] or per_step[0]["b7"] < 1 or len(fwd) != 2 * len(fwd0):
        raise AssertionError(f"zero-init output runs: first |pred| {fwd0[0][1]} and "
                             f"{fwd[0][1]}, launches a step {per_step}")
    log(f"[14c] train_large GNN N={LARGE_N}: s per epoch {tr['seconds_per_epoch']}, peak "
        f"memory {peak:.3f} GiB, stepwise {ev['stepwise_scaled_rmse']:.6g} against the "
        f"predict-zero baseline {ev['predict_zero_baseline_scaled_rmse']:.6g}")
    if not (len(tr["seconds_per_epoch"]) == 2
            and all(math.isfinite(v) for v in (tr["first_scaled_rmse"], tr["final_scaled_rmse"],
                                               *tr["seconds_per_epoch"]))):
        raise AssertionError(f"train_large GNN N={LARGE_N}: training {tr}")
    ran = {k: ran[k] + c + large0[k] for k, c in large.items()}
    log(f"[14] launches on the training configurations' paths: {ran}")
    if min(ran[k] for k in ("b1", "b2", "b3", "b4", "b5", "b7", "b8", "b9", "b10", "b1n")) == 0 \
            or ran["b6"] or ran["b11"]:
        raise AssertionError(f"training configurations' launches {ran}")
    return ran


def main() -> int:
    card = phase0_device()
    import torch

    from nbody_tpu_torch.ops import pairwise as pw

    stamp("0 (build)")
    phase0b_prng(card)
    stamp("0b (prng)")
    phase0c_flax_init(card)
    stamp("0c (flax init)")
    big = phase1_kernels()
    stamp("1")
    slice2 = phase5_large_n_kernels()
    stamp("5")
    slice3 = phase7_backward_kernels()
    stamp("7 (kernels)")
    phase7_caps()
    stamp("7c (past the old caps)")
    slice4 = phase9_kernels()
    phase9_engines()
    stamp("9a-9b")
    slice5 = phase10_kernel()

    # the position-gradient path: B6's launches are counted here
    zero_counts()
    launches = {"b6": phase7_model_gradients()}

    # the datagen and GNN-eval path: every launch counter starts at 0 here
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_dir = os.path.join(tmp, "test")
        os.makedirs(data_dir)
        phase2_datagen(data_dir)
        traj, masses = phase3_real_size()
        stamp("7 (model), 2, 3")
        exact_20k_ms = phase4_surrogate(data_dir, traj)
        stamp("4")
    launches.update(b1=pw.partial_accelerations.launches, b2=pw.pair_potential.launches)
    torch.cuda.synchronize()
    # measurements of that path's steps, after its counts are read
    energy_kernels_per_energy()
    ground_truth_step_profile(traj, masses)
    stamp("2-3 (profiles)")

    # the grouped datagen path: counters at 0 again, read right after the
    # grouped run (phase 2b), before its one-scene-at-a-time twin
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_groups_") as tmp:
        grouped, group_numbers = phase2b_grouped_datagen(tmp)
    launches.update(grouped)
    stamp("2b")
    phase2c_real_size()
    stamp("2c")

    # the large-N surrogate path: counters at 0 again
    zero_counts()
    phase6_large_n_path(exact_20k_ms)
    torch.cuda.synchronize()
    large = read_counts()
    log(f"[6] launches on the large-N path: {large}")
    stamp("6")
    launches.update({k: large[k] for k in ("b7", "b8")}, **by_resolution("b3"))
    if large["b1"] == 0:
        raise AssertionError(f"the large-N path never launched B1: {large}")

    # the training path: counters at 0 again
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        phase8_training(tmp)
    torch.cuda.synchronize()
    train = read_counts()
    log(f"[8] launches on the training path: {train}")
    stamp("8")
    launches.update(**by_resolution("b4"), **by_resolution("b5"))
    if min(train[k] for k in ("b1", "b3", "b4", "b5", "b7", "b8")) == 0 or train["b6"] != 0:
        raise AssertionError(f"training path launches {train}: B6 must stay at 0, the "
                             f"others above it")

    # the treecode path: counters at 0 again
    zero_counts()
    phase9_rollouts()
    torch.cuda.synchronize()
    tree = read_counts()
    log(f"[9c] launches on the treecode path: {tree}")
    launches.update({k: tree[k] for k in ("b9", "b10", "b1n")})
    if min(tree[k] for k in ("b1", "b2", "b9", "b10", "b1n")) == 0:
        raise AssertionError(f"the treecode path never launched a kernel of its own: {tree}")
    phase9_bench()
    stamp("9c")

    # scene groups: a treecode group's rollout and a batch's Morton graph,
    # each driven with the counters at 0 just before it and read just after
    slice6 = phase12_group_kernels()
    ran_bh = phase12_group_rollout("bh", BH_100K, GROUP_BH, True, 130)
    ran_bh3 = phase12_group_rollout("bh3", BH3_1M, GROUP_BH3, False, 150)
    ran_morton, morton = phase12_morton()
    slice6.update(morton)
    launches.update({f"{k}g": ran_bh[k] + ran_bh3[k] for k in ("b9", "b10", "b1n")},
                    b7g=ran_morton["b7"], b8g=ran_morton["b8"])
    stamp("12")

    # the 2M-10M treecodes: each entry point's main with the counters at 0
    phase13_large_treecodes()
    phase13_kernels()
    phase13_tier_paths()
    stamp("13")

    # the sub-2M sweeps: counters at 0 before each artifact's rows
    phase15_sweeps(card)
    stamp("15")

    # the training configurations at full width: counters at 0 in the phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_configs_") as tmp:
        phase14_training_configs(tmp)
    stamp("14")

    # B11 on the crossover path's own data: its launches are counted here
    zero_counts()
    launches["b11"] = phase10_path_data()
    phase10_fused_forward()
    stamp("10a-10c")

    # the large-N entry points' path: each main starts with the counters at
    # 0 and is read, and held to its kernels, right after it returns
    with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as tmp:
        large_n = phase10_crossover(tmp)
        for name, c in phase10_train_large(tmp).items():
            large_n[name] += c
    torch.cuda.synchronize()
    log(f"[10] launches of the large-N entry points' mains together: {large_n}")
    stamp("10d-10e")
    phase10_knn_recall()
    phase10_knn_approx()
    stamp("10f")

    # the sharded paths (parallel/): the ranks count their own launches
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        phase11_parallel(tmp, card)
    stamp("11")
    # B3, B4 and B5 stand in the line once for each layer's filter resolution,
    # B1, B2, B7-B10 and the near list once more for scene groups
    if min(launches.values()) == 0 or len(launches) != len(kernel_wrappers()) + 10:
        raise AssertionError(f"a kernel of a path never launched: {launches}")
    if any(m.split(".")[0] in ("jax", "flax", "nbody_tpu") for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    def entry(name, source, replaces, key, numbers):
        # no one PyTorch call computes any of these functions: library_ms null
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": numbers[0], "ms": numbers[1],
                "plain_ms": numbers[2], "bound_ms": numbers[3][0],
                "bound_by": numbers[3][1], "library_ms": None}

    pair_src = "nbody_tpu_torch/csrc/pairwise.cu"
    spatial_src = "nbody_tpu_torch/csrc/spatial.cu"
    conv_src = "nbody_tpu_torch/csrc/contconv.cu"
    conv_py = "nbody_tpu/ops/contconv_kernel.py"
    tree_src = "nbody_tpu_torch/csrc/treeforce.cu"
    kernels = [
        entry("B1 force (nbody_force)", pair_src, "nbody_tpu/ops/pairwise.py:50", "b1",
              big["b1"]),
        entry("B2 energy (nbody_energy)", pair_src, "nbody_tpu/ops/pairwise.py:113", "b2",
              big["b2"]),
        entry(f"B1 force, scene groups (nbody_force, {len(GROUP_SEEDS)} x {RECIPE_N[-1]})",
              pair_src, "nbody_tpu/ops/pairwise.py:50", "b1g", group_numbers["b1g"]),
        entry(f"B2 energy, scene groups (nbody_energy, {len(GROUP_SEEDS)} x {RECIPE_N[-1]})",
              pair_src, "nbody_tpu/ops/pairwise.py:113", "b2g", group_numbers["b2g"]),
        *(entry(f"B3 collect (contconv_collect), D={d}", conv_src, f"{conv_py}:105",
                f"b3_d{d}", slice2[f"b3_d{d}"]) for d in (6, 4)),
        *(entry(f"B4 filter grad (contconv_bwd_filters), D={d}", conv_src,
                f"{conv_py}:129", f"b4_d{d}", slice3[f"b4_d{d}"]) for d in (6, 4)),
        *(entry(f"B5 feature grad (contconv_bwd_feat), D={d}", conv_src, f"{conv_py}:162",
                f"b5_d{d}", slice3[f"b5_d{d}"]) for d in (6, 4)),
        entry("B6 geometry grad (contconv_bwd_geom)", conv_src, f"{conv_py}:196", "b6",
              slice3["b6"]),
        entry("B7 select (morton_select)", spatial_src, "nbody_tpu/ops/spatial.py:272",
              "b7", slice2["b7"]),
        entry("B8 merge (morton_merge)", spatial_src, "nbody_tpu/ops/spatial.py:311",
              "b8", slice2["b8"]),
        entry("B9 far field (multipole_acc)", tree_src, "nbody_tpu/ops/treeforce.py:259",
              "b9", slice4["b9"]),
        entry("B10 grouped multipoles (grouped_multipole_acc)", tree_src,
              "nbody_tpu/ops/treeforce.py:566", "b10", slice4["b10"]),
        entry("B1 near list (nbody_near_force)", pair_src, "nbody_tpu/ops/pairwise.py:50",
              "b1n", slice4["b1n"]),
        entry(f"B7 select, a batch's graph ({MORTON_GROUP[0]} x {MORTON_GROUP[1]})",
              spatial_src, "nbody_tpu/ops/spatial.py:272", "b7g", slice6["b7g"]),
        entry(f"B8 merge, a batch's graph ({MORTON_GROUP[0]} x {MORTON_GROUP[1]})",
              spatial_src, "nbody_tpu/ops/spatial.py:311", "b8g", slice6["b8g"]),
        entry(f"B9 far field, scene groups ({GROUP_BH[0]} x {GROUP_BH[1]})", tree_src,
              "nbody_tpu/ops/treeforce.py:259", "b9g", slice6["b9g"]),
        entry(f"B10 grouped multipoles, scene groups ({GROUP_BH[0]} x {GROUP_BH[1]})",
              tree_src, "nbody_tpu/ops/treeforce.py:566", "b10g", slice6["b10g"]),
        entry(f"B1 near list, scene groups ({GROUP_BH[0]} x {GROUP_BH[1]})", pair_src,
              "nbody_tpu/ops/pairwise.py:50", "b1ng", slice6["b1ng"]),
        entry("B11 windowed EdgeConv sum (edgeconv_windowed_tanh_sum)",
              "nbody_tpu_torch/csrc/edgeconv.cu", "attic/edgeconv_kernel.py:88", "b11",
              slice5),
    ]
    assert all(math.isfinite(k[f]) for k in kernels
               for f in ("max_abs_err", "ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
