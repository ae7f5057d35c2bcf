"""Rank bodies of the ``tests/test_torch_parallel_*.py`` files.

``parallel.launch.run_ranks`` starts each rank in a fresh process that
imports the body's module, so the bodies live here, in a module that
imports only torch, numpy and the port: no rank imports JAX. Each body runs
every case of its test file in one launch, sharded, and beside it the
port's single-rank result on rank 0, and returns numpy arrays by case name
(rank 0's).
"""

import numpy as np
import torch
import torch.distributed as dist

from nbody_tpu_torch.parallel import bh, ring
from nbody_tpu_torch.parallel.launch import imported_jax
from nbody_tpu_torch.parallel.mesh import make_mesh

G, EPS = 4.5e-6, 0.05


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(t):
    return t.detach().cpu().numpy()


def _finish(out):
    if imported_jax():
        raise AssertionError(f"a rank imported JAX: {imported_jax()}")
    return out if dist.get_rank() == 0 else None


# ------------------------------------------------------------ ring and bh

def ring_bh(device, inp):
    """The cases of ``test_torch_parallel_ring_bh.py`` on 4 ranks: the
    2-rank cases on a (2, 2) mesh (two particle groups of 2 ranks each, the
    same work), the 4-rank ones along every rank."""
    from nbody_tpu_torch.core.simulate import SimulationConfig, simulate
    from nbody_tpu_torch.ops import treeforce as tf
    from nbody_tpu_torch.ops.treeforce import partition_from_numpy

    torch.set_num_threads(1)
    mesh2 = make_mesh(axis_names=("particles", "replica"), shape=(2, 2))
    mesh4 = make_mesh()
    meshes = {2: mesh2, 4: mesh4}
    out = {}

    for name, c in inp["ring"].items():
        p, v, m = (_t(c[k]) for k in ("pos", "vel", "mass"))
        mesh = meshes[c["ranks"]]
        if c["kind"] == "acc":
            out[name] = _n(ring.ring_accelerations(p, m, G, EPS, mesh, backend=c["backend"]))
        elif c["kind"] == "energies":
            out[name] = np.array([float(e) for e in ring.ring_energies(p, v, m, G, EPS, mesh)])
        else:
            (ps, vs, accs), en = ring.ring_simulate(
                p, v, m, c["steps"], G, EPS, c["dt"], mesh, backend=c["backend"],
                calc_energy=c["traj"], return_trajectory=c["traj"])
            out[name] = {"pos": _n(ps), "vel": _n(vs), "acc": _n(accs)}
            if c["traj"]:
                out[name].update(u=_n(en[0]), k=_n(en[1]))
            if dist.get_rank() == 0 and not c["traj"]:
                cfg = SimulationConfig(g_const=G, softening=EPS, dt=c["dt"],
                                       calc_energy=False, force_backend=c["backend"])
                traj = simulate(p, v, m, c["steps"], cfg)
                out[name]["single_pos"] = _n(traj.positions[-1])

    for name, c in inp["tree"].items():
        engine, kw = c["engine"], dict(c["knobs"])
        p, v, m = (_t(c[k]) for k in ("pos", "vel", "mass"))
        mesh = meshes[c["ranks"]]
        if c.get("kind") == "simulate":
            pf, vf, _ = getattr(bh, f"{engine}_simulate")(p, v, m, c["steps"], G, EPS, 1e-4,
                                                           mesh, **kw)
            out[name] = {"pos": _n(pf), "vel": _n(vf)}
            if dist.get_rank() == 0:
                cfg = dict(bh_near=kw["n_near"], bh_block=kw["block"],
                           bh_refresh=kw["refresh"])
                if engine != "bh":
                    cfg.update(bh_coarse=kw["coarse"], bh_rc=kw["rc"])
                if engine == "bh3":
                    cfg.update(bh_sub_block=kw["sub_block"], bh_n_sub=kw["n_sub"])
                traj = simulate(p, v, m, c["steps"], SimulationConfig(
                    g_const=G, softening=EPS, dt=1e-4, calc_energy=False,
                    force_backend=engine, **cfg))
                out[name].update(single_pos=_n(traj.positions[-1]),
                                 single_vel=_n(traj.velocities[-1]))
            continue
        sharded = getattr(bh, f"sharded_{engine}_accelerations")
        single = getattr(tf, f"{engine}_accelerations")
        q = p + v * 1e-3 if c.get("drift") else p
        res = {}
        own = {k: kw[k] for k in kw if k != "near_impl"}
        impl = kw.get("near_impl", "dense")
        if not c.get("drift"):  # partitions built inside, from the gathered positions
            res["sharded"] = _n(sharded(q, m, G, EPS, mesh, near_impl=impl, **own))
            if dist.get_rank() == 0:
                res["single"] = _n(single(q, m, G, EPS, near_impl=impl, **own))
        if "jax_partition" in c:  # the JAX partition carried over
            part = partition_from_numpy(c["jax_partition"])
            res["carried"] = _n(sharded(q, m, G, EPS, mesh, partition=part, near_impl=impl,
                                        **c.get("ignored", {})))
            if dist.get_rank() == 0:
                res["carried_single"] = _n(single(q, m, G, EPS, partition=part,
                                                  near_impl=impl))
        out[name] = res
    return _finish(out)


# -------------------------------------------------------------- surrogate

def _port_model(spec):
    from nbody_tpu_torch.models import ContinuousConvModel, GraphModel

    cls = GraphModel if spec["family"] == "gnn" else ContinuousConvModel
    model = cls(**spec["kwargs"])
    model.load_state_dict({k: _t(v) for k, v in spec["state"].items()})
    return model


def surrogate(device, inp):
    """The cases of ``test_torch_parallel_surrogate.py`` on 2 ranks: each
    sharded function on converted JAX weights, and the port's single-rank
    function beside it on rank 0."""
    from nbody_tpu_torch.parallel import surrogate as ps
    from nbody_tpu_torch.train.graphs import build_graph
    from nbody_tpu_torch.train.rollout import autoregressive_rollout, predict_accelerations

    torch.set_num_threads(1)
    mesh = make_mesh()
    rank0 = dist.get_rank() == 0
    out = {}
    for name, c in inp.items():
        model = _port_model(c["model"])
        gnn = c["model"]["family"] == "gnn"
        p, v, m = (_t(c[k]) for k in ("pos", "vel", "mass"))
        res = {}
        if c["kind"] == "predict":
            fn = ps.sharded_predict if gnn else ps.sharded_contconv_predict
            res["sharded"] = _n(fn(model, p, v, m, mesh))
            if rank0:
                res["single"] = _n(predict_accelerations(model, p, v, m))
        elif c["kind"] == "rollout":
            fn = ps.sharded_rollout if gnn else ps.sharded_contconv_rollout
            res["sharded"] = [_n(t) for t in fn(model, p, v, m, c["steps"], c["dt"], mesh)]
            if rank0:
                res["single"] = [_n(t) for t in autoregressive_rollout(
                    model, p, v, m, c["steps"], c["dt"])]
        elif c["kind"] == "grad":
            y = _t(c["y"])
            single_model = _port_model(c["model"])
            if gnn:
                loss, grads = ps.sharded_loss_and_grad(model, p, v, m, y, mesh)
            else:
                loss, grads, stats = ps.sharded_contconv_loss_and_grad(model, p, v, m, y,
                                                                       mesh)
                res["stats"] = {k: _n(t) for k, t in stats.items()}
            res["loss"], res["grads"] = float(loss), {k: _n(g) for k, g in grads.items()}
            if rank0:  # the single-rank step: train mode for ContConv, as JAX's test
                single_model.train(not gnn)
                x = torch.cat([p, v, m[:, None]], -1)[None]
                idx, valid = build_graph(single_model.graph_spec, x[..., :3])
                pred = single_model(x, idx, valid)[0]
                sl = torch.sqrt(((single_model.scale_factor * (pred - y)) ** 2).mean())
                named = dict(single_model.named_parameters())
                gs = torch.autograd.grad(sl, [named[k] for k in grads])
                res["single_loss"] = float(sl)
                res["single_grads"] = {k: _n(g) for k, g in zip(grads, gs)}
                if not gnn:
                    res["single_stats"] = {k: _n(t) for k, t in
                                           single_model.state_dict().items()
                                           if k.endswith(("running_mean", "running_var"))}
        elif c["kind"] == "descend":
            y = _t(c["y"])
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            losses = []
            for _ in range(5):
                if gnn:
                    loss, grads = ps.sharded_loss_and_grad(model, p, v, m, y, mesh)
                else:
                    loss, grads, _ = ps.sharded_contconv_loss_and_grad(model, p, v, m, y,
                                                                       mesh)
                for k, t in model.named_parameters():
                    t.grad = grads[k]
                opt.step()
                losses.append(float(loss))
            res["losses"] = np.array(losses)
        elif c["kind"] == "chunks":
            for conv in model.convs:
                conv.node_chunks = 2
            try:
                ps.sharded_contconv_predict(model, p, v, m, mesh)
                res["raised"] = ""
            except ValueError as e:
                res["raised"] = str(e)
        out[name] = res
    return _finish(out)


# ------------------------------------------------------------ training

def train(device, inp):
    """The cases of ``test_torch_parallel_train.py`` on 2 ranks:
    ``Trainer(mesh=)`` epochs from converted JAX weights, a checkpointed
    run and its resume, and the dryrun's paths."""
    from nbody_tpu_torch.parallel import dryrun
    from nbody_tpu_torch.parallel.mesh import DATA_AXIS
    from nbody_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    mesh = make_mesh(axis_names=(DATA_AXIS,))
    out = {}
    for name, c in inp["cases"].items():
        t = Trainer(_port_model(c["model"]), learning_rate=0.01, dt=1e-4, seed=0, mesh=mesh)
        losses, mses = t.train_from_dir(inp["dir"], epochs=c["epochs"],
                                        batch_size=c["batch_size"], verbose=False,
                                        batch_mode=c["mode"])
        out[name] = {"losses": np.array(losses), "mses": np.array(mses),
                     "state": {k: _n(v) for k, v in t.model.state_dict().items()}}

    c = inp["resume"]
    ckpt = c["dir"]
    first = Trainer(_port_model(c["model"]), learning_rate=0.01, dt=1e-4, mesh=mesh)
    l1, _ = first.train_from_dir(inp["dir"], epochs=2, batch_size=8, save_every=1,
                                 save_path=ckpt, verbose=False)
    dist.barrier()  # rank 0's checkpoints are on disk before any rank resumes
    again = Trainer(_port_model(c["model"]), learning_rate=0.01, dt=1e-4, mesh=mesh)
    l2, _ = again.train_from_dir(inp["dir"], epochs=1, batch_size=8, save_every=1,
                                 save_path=ckpt, verbose=False)
    epochs = torch.tensor([float(again.epoch)])
    dist.all_reduce(epochs)  # every rank resumed at the same epoch
    out["resume"] = {"losses": np.array(l1 + l2), "epoch": again.epoch,
                     "epoch_sum": float(epochs), "writes": [first.writes]}
    writes = torch.tensor([float(first.writes)])
    dist.all_reduce(writes)
    out["resume"]["writers"] = float(writes)

    out["dryrun"] = dryrun.check_paths(device, dryrun.small_spec(inp["dryrun_dir"]))
    return _finish(out)


def fail_on_rank_1(device, message):
    """Raises on rank 1 after a collective that every rank joins, while
    rank 0 waits in the next one."""
    dist.barrier()
    if dist.get_rank() == 1:
        raise ValueError(message)
    dist.barrier()
    return "rank 0 finished"
