"""Rank program of the port's mesh tests: one process a rank, gloo, CPU.

``spawn(world, task, args, tmp_path)`` starts ``world`` copies of this
file, each a rank of a ``torch.distributed`` group over gloo (a file store
in ``tmp_path``, so concurrent test workers never race for a port), runs
``TASKS[task](**args)`` on every rank and returns every rank's result, in
rank order. A rank that fails, or a run past ``timeout`` seconds, fails
the caller with every rank's stderr. The ranks import only the port (and
``_torch_resume_prog``); the reference runs in the calling test.

    PYTHONPATH=src:tests python tests/_torch_mesh_prog.py --rank 0 \
        --world 2 --init /tmp/x/init --spec /tmp/x/spec.pkl --out /tmp/x/out
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
MEASURED = ("wall_s", "phase_s")


def spawn(world: int, task: str, args: dict, tmp_path, timeout: float = 240,
          threads: int = 1) -> list:
    tmp = str(tmp_path)
    tag = f"{task}-{world}-{time.monotonic_ns()}"
    spec = os.path.join(tmp, f"{tag}.spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"task": task, "args": args}, f)
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(HERE, "..", "src"))
    env["PYTHONPATH"] = os.pathsep.join(
        [src, HERE] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = str(threads)
    for name in ("REPRO_MODEL_SHARDS", "REPRO_DIST_BACKEND"):
        env.pop(name, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world),
         "--init", os.path.join(tmp, f"{tag}.init"), "--spec", spec,
         "--out", os.path.join(tmp, tag), "--threads", str(threads)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{task} on {world} ranks ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        report = "\n".join(f"--- rank {r} rc={p.returncode}\n{e[-4000:]}"
                           for r, (p, (_, e)) in enumerate(zip(procs, outs)))
        raise AssertionError(f"{task} on {world} ranks failed:\n{report}")
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}.{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def strip(logs) -> list:
    """Round logs as dicts, without the measured fields."""
    return [{k: v for k, v in (dataclasses.asdict(lg)
                               if dataclasses.is_dataclass(lg) else lg).items()
             if k not in MEASURED} for lg in logs]


def arch_cfg(spec: Optional[dict]):
    """An ``ArchConfig`` from ``{"arch": registry name, "reduced": the
    kwargs of configs.reduced, "replace": fields replaced after}`` (None
    for None)."""
    if spec is None:
        return None
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(spec["arch"]), **spec.get("reduced", {}))
    return dataclasses.replace(cfg, **spec.get("replace", {}))


def port_logs(kw: dict, dataset: str = "mnist_feat", n_train: int = 800,
              n_test: int = 200, costs=None, arch=None) -> list:
    """An unsharded run of ``kw`` (a ``FedConfig``'s fields) in this
    process, on the CPU (``arch``: an ``arch_cfg`` spec for token
    clients): its round logs."""
    from repro_torch.common.types import FedConfig
    from repro_torch.core.methods import get_method
    from repro_torch.core.protocol import engine_from_config, make_scheduler
    from repro_torch.fed import simulator
    cfg = FedConfig(**kw)
    clients, server, x_test, y_test = simulator.build_experiment(
        cfg, dataset, n_train=n_train, n_test=n_test, device="cpu",
        transformer_cfg=arch_cfg(arch))
    engine = engine_from_config(clients, cfg)
    method = get_method(cfg.method)
    if method.client_filter != "none":
        engine.learn_dres(cfg.seed)
    sched = make_scheduler(engine, server, method, cfg, x_test, y_test,
                           sim_phase_costs=costs)
    return sched.run_rounds(0, cfg.rounds)


# ----------------------------------------------------------------- tasks

def state_bytes(engine) -> int:
    """This rank's stacked parameters and momentum, from the tensors (a
    waved cohort's host masters included)."""
    total = 0
    for c in engine.cohorts:
        for t in list(c.params) + list(c.opt_state["mu"]):
            total += (t.nbytes if not hasattr(t, "numel")
                      else t.numel() * t.element_size())
    return total


def _experiment(item: dict):
    from repro_torch.common.types import FedConfig
    from repro_torch.data.synthetic import dataset_from_arrays
    from repro_torch.fed import simulator
    cfg = FedConfig(**item["kw"])
    arrays = item.get("arrays")
    kw = dict(n_train=item.get("n_train", 800), n_test=item.get("n_test", 200),
              device="cpu", transformer_cfg=arch_cfg(item.get("arch")))
    if arrays is not None:
        kw.update(dataset=dataset_from_arrays(*arrays["dataset"]),
                  init_params=arrays["params"],
                  kmeans_inits=arrays["kmeans_inits"],
                  kulsif_aux=arrays["kulsif_aux"],
                  student_params=arrays["student_params"])
    return cfg, simulator.build_experiment(
        cfg, item.get("dataset", "mnist_feat"), **kw)


def run(items: list) -> list:
    """Each item's experiment (``kw``: a ``FedConfig``'s fields; optional
    ``arrays``: the reference's dataset, inits and seeds; ``costs``: fixed
    phase costs) through the port's ``run_experiment`` steps: its round
    logs, trace and this rank's state bytes (``bytes_only``: the bytes
    alone, nothing run)."""
    from repro_torch.core.methods import get_method
    from repro_torch.core.protocol import engine_from_config, make_scheduler
    out = []
    for item in items:
        cfg, (clients, server, x_test, y_test) = _experiment(item)
        engine = engine_from_config(clients, cfg)
        mesh = getattr(engine, "mesh", None)
        rec = {"state_bytes": state_bytes(engine),
               "mesh": None if mesh is None else dict(mesh.shape)}
        if not item.get("bytes_only"):
            method = get_method(cfg.method)
            if method.client_filter != "none":
                engine.learn_dres(cfg.seed)
            sched = make_scheduler(engine, server, method, cfg, x_test,
                                   y_test, sim_phase_costs=item.get("costs"))
            logs = sched.run_rounds(0, cfg.rounds)
            engine.sync_to_clients()
            rec.update(logs=[dataclasses.asdict(lg) for lg in logs],
                       trace=list(sched.trace),
                       params=[[p.detach().numpy().copy() for p in c.params]
                               for c in clients])
        out.append(rec)
    return out


def resume(cases: list) -> list:
    """``_torch_resume_prog.check_resume`` (``kind`` "resume") and
    ``check_cross_engine`` ("cross") cases, on this world."""
    import _torch_resume_prog as prog
    out = []
    for case in cases:
        case = dict(case)
        kind = case.pop("kind")
        if kind == "resume":
            out.append(prog.check_resume(**case))
        else:
            prog.check_cross_engine(**case)
            out.append(True)
    return out


def psum(logits, masks) -> list:
    """``masked_mean_logits_psum`` of this rank's client (row ``rank``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.aggregation import masked_mean_logits_psum
    r = dist.get_rank()
    teacher, valid = masked_mean_logits_psum(torch.as_tensor(logits[r]),
                                             torch.as_tensor(masks[r]))
    return [teacher.numpy(), valid.numpy()]


def collectives(model_shards: int, seed: int = 0) -> dict:
    """The reduced-granite backbone of 3 stacked lanes under ``vmap``, on a
    ``(world // model_shards, model_shards)`` mesh: this rank's
    loss and the gradient of every leaf gathered whole, beside the same
    on whole leaves without a model axis, and the three collectives on
    their own under ``vmap`` (forward and gradient)."""
    import numpy as np
    import torch
    from torch.func import functional_call, vmap

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.fd_trainer import TransformerClientModel
    from repro_torch.fed import mesh as M
    from repro_torch.models import sharding

    mesh = M.build_client_mesh(-1, model_shards=model_shards)
    cfg = reduced(get_arch("granite-8b"), layers=2, d_model=64, vocab=32)
    gen = torch.Generator().manual_seed(seed)
    models = [TransformerClientModel(cfg, generator=gen) for _ in range(3)]
    names = [n for n, _ in models[0].named_parameters()]
    whole = [torch.stack([dict(m.named_parameters())[n].detach()
                          for m in models]) for n in names]
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, 32, (3, 5, 8)))
    target = torch.as_tensor(rng.normal(size=(3, 5, 32)), dtype=torch.float32)

    def loss_of(params, mp_mesh):
        with sharding.model_parallel(mp_mesh):
            def one(p, x):
                return functional_call(models[0], dict(zip(names, p)), (x,))
            out = vmap(one)(params, tokens)
        return ((out - target) ** 2).sum(), out

    ref = [w.clone().requires_grad_(True) for w in whole]
    l_ref, o_ref = loss_of(ref, None)
    g_ref = torch.autograd.grad(l_ref, ref)
    splits = [M.model_split(n.split(".")[-1], w.shape[1:], mesh)
              for n, w in zip(names, whole)]
    ax, idx = "model", mesh.coord("model")
    loc = [(w if s is None else M.model_block(w, s + 1, mesh))
           .clone().requires_grad_(True) for w, s in zip(whole, splits)]
    l_mp, o_mp = loss_of(loc, mesh)
    g_mp = torch.autograd.grad(l_mp, loc)
    g_whole = [g if s is None else mesh.gather(g, ax, s + 1)
               for g, s in zip(g_mp, splits)]
    # each collective alone under vmap: forward and gradient
    x = torch.as_tensor(rng.normal(size=(3, 4, 6)), dtype=torch.float32)
    xs = x.clone().requires_grad_(True)
    with sharding.model_parallel(mesh):
        def fns(v):
            a = sharding.copy_to_model(v) * (idx + 1.0)
            b = sharding.reduce_from_model(v * (idx + 1.0))
            c = sharding.gather_from_model(v * (idx + 1.0), 1)
            return a.sum() + (b * b).sum() + (c * c).sum(), (a, b, c)
        total, (a, b, c) = vmap(lambda v: fns(v), out_dims=(0, 0))(xs)
    gx = torch.autograd.grad(total.sum(), xs)[0]
    return {"splits": splits, "loss": float(l_mp), "loss_ref": float(l_ref),
            "out": o_mp.detach().numpy(), "out_ref": o_ref.detach().numpy(),
            "grads": [g.numpy() for g in g_whole],
            "grads_ref": [g.numpy() for g in g_ref],
            "coll": [t.detach().numpy() for t in (a, b, c)],
            "coll_grad": gx.numpy(), "x": x.numpy(), "names": names}


def many(tasks: list) -> list:
    """Several ``(task, args)`` in one world, in order."""
    return [TASKS[name](**args) for name, args in tasks]


def fd_step(arch: dict, params: list, batches: list, proxy, owner,
            centroids: list, thresholds: list, lr: float) -> dict:
    """``core.fd_trainer.make_fd_train_step`` on this rank's client (row
    ``rank`` of each list), one SGD step over the 1-D client mesh: the
    updated parameters (the reference's pytree) and the metrics."""
    import torch
    import torch.distributed as dist

    from repro_torch.common.types import ArchConfig, MoEConfig
    from repro_torch.core import fd_trainer as FD
    from repro_torch.fed import mesh as M
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import sgd
    r = dist.get_rank()
    arch = dict(arch)
    if arch.get("moe") is not None:
        arch["moe"] = MoEConfig(**arch["moe"])
    model = Transformer(ArchConfig(**arch)).load_jax_params(params[r])
    opt = sgd(lr)
    mesh = M.build_client_mesh(-1)
    step = FD.make_fd_train_step(opt, axis_name="clients", mesh=mesh)
    state, metrics = step(
        model, opt.init(list(model.parameters())),
        {k: torch.as_tensor(v).long() for k, v in batches[r].items()},
        torch.as_tensor(proxy).long(), torch.as_tensor(owner),
        torch.as_tensor(centroids[r]), float(thresholds[r]), r)
    return {"params": model.jax_params(),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def c11(items: list) -> list:
    """Each item's experiment built on this rank (as ``run``), its
    engine made: whether any client's module holds parameter storage,
    this rank's owned members and its stacked state's shapes; after
    ``rounds`` rounds (``run_rounds``), the engine's ``state_dict`` on
    every rank (whole on rank 0 alone) and the stacked parameters before
    it and after loading it back."""
    import numpy as np

    from repro_torch.core.methods import get_method
    from repro_torch.core.protocol import engine_from_config, make_scheduler
    out = []
    for item in items:
        cfg, (clients, server, x_test, y_test) = _experiment(item)
        rec = {"member_storage": [
            [not p.is_meta for p in c.params] for c in clients],
            "shards": [getattr(c, "shard", None) is not None
                       for c in clients]}
        engine = engine_from_config(clients, cfg)
        rec["owned"] = [[cohort.positions[i] for i in cohort._owned()]
                        for cohort in engine.cohorts]
        rec["stacked"] = [[tuple(p.shape) for p in cohort.params]
                          for cohort in engine.cohorts]
        rec["state_bytes"] = state_bytes(engine)
        rec["left_shards"] = [getattr(c, "shard", None) is not None
                              for c in clients]
        if item.get("rounds"):
            method = get_method(cfg.method)
            if method.client_filter != "none":
                engine.learn_dres(cfg.seed)
            sched = make_scheduler(engine, server, method, cfg, x_test,
                                   y_test, sim_phase_costs=item.get("costs"))
            rec["logs"] = strip(sched.run_rounds(0, item["rounds"]))
        def host(t):      # a device tensor, or a waved host master
            return np.array(getattr(t, "detach", lambda: t)(), copy=True)
        rec["before"] = [[host(p) for p in cohort.params]
                         for cohort in engine.cohorts]
        sd = engine.state_dict()
        rec["state_dict"] = sd
        # a rank restores its own restore point, or rank 0's checkpoint
        engine.load_state_dict(sd)
        rec["after_load"] = [[host(p) for p in cohort.params]
                             for cohort in engine.cohorts]
        rec["member_storage_after"] = [
            [not p.is_meta for p in c.params] for c in clients]
        out.append(rec)
    return out


# ------------------------------------------ the families under a model axis

def _family_inputs(cfg, batch: int, seq: int, seed: int):
    """A batch for ``train_loss`` (numpy draws from ``seed``) and the
    forward's keyword arguments."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = torch.as_tensor(rng.normal(
            size=(batch, seq, cfg.frontend_stub_dim)), dtype=torch.float32)
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (batch, seq)))
        return {"frames": frames, "labels": labels}, {"frames": frames}
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)))
    out = {"tokens": tokens, "labels": labels}
    kw = {"tokens": tokens}
    if cfg.family == "vlm":
        out["vision"] = kw["vision"] = torch.as_tensor(rng.normal(
            size=(batch, cfg.num_vision_tokens, cfg.d_model)),
            dtype=torch.float32)
    return out, kw


def _decode(model, cfg, prompt, n_new: int, cache_len: int, vision=None):
    """The prompt replayed through ``decode_step`` into a fresh cache,
    then ``n_new`` greedy steps: (tokens (B, n_new), every step's logits
    (B, S0 + n_new - 1, V))."""
    import torch

    from repro_torch.models import transformer as T
    b, s0 = prompt.shape
    cache = T.init_cache(cfg, b, cache_len, torch.float32, vision=vision,
                         params=model if vision is not None else None)
    logits, toks = [], []
    tok = None
    for t in range(s0 + n_new - 1):
        inp = prompt[:, t:t + 1] if t < s0 else tok
        lg, cache = T.decode_step(model, inp, cache, t)
        logits.append(lg[:, 0])
        tok = torch.argmax(lg[:, -1:], dim=-1)
        if t >= s0 - 1:
            toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits, 1)


def _family_case(case: dict, mesh) -> dict:
    """One family case (``cfg``: an ``arch_cfg`` spec; its weights drawn
    from ``seed``, or ``params``, the reference's tree): its forward
    logits, ``train_loss`` and every leaf's gradient, unsharded and on
    ``mesh``'s model axis (gathered whole), and with ``decode`` its
    greedy decode (tokens and every step's logits), both ways. The
    inputs are ``_family_inputs``'s at ``batch``, ``seq`` and ``seed``."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    cfg = arch_cfg(case["cfg"])
    model = T.Transformer(cfg, generator=torch.Generator().manual_seed(
        case.get("seed", 0)))
    if case.get("params") is not None:
        model.load_jax_params(case["params"])
    if cfg.family == "vlm":
        with torch.no_grad():
            for grp in model.blocks:
                grp["cross"]["gate_attn"].fill_(case.get("gate", 0.5))
                grp["cross"]["gate_mlp"].fill_(case.get("gate", 0.5))
    batch, fkw = _family_inputs(cfg, case.get("batch", 2),
                                case.get("seq", 12), case.get("seed", 0))
    split = copy.deepcopy(model).shard(mesh)
    out = {"splits": {n: split._splits[id(p)]
                      for n, p in split.named_parameters()}}
    remat = case.get("remat", False)
    for name, m, mp_mesh in (("ref", model, None), ("mp", split, mesh)):
        with sharding.model_parallel(mp_mesh):
            logits = m(**fkw)
            loss, _ = T.train_loss(m, batch, remat=remat)
            params = list(m.parameters())
            grads = torch.autograd.grad(loss, params)
            grads = m.whole_values(grads)
            res = {"logits": logits.detach().numpy(), "loss": float(loss),
                   "grads": [g.numpy() for g in grads],
                   "names": [n for n, _ in m.named_parameters()]}
            if case.get("decode"):
                with torch.no_grad():
                    rng = np.random.default_rng(1)
                    prompt = torch.as_tensor(rng.integers(
                        0, cfg.vocab_size, (2, case.get("prompt", 6))))
                    toks, lg = _decode(m, cfg, prompt, case.get("new", 6),
                                       case.get("cache_len", 16),
                                       batch.get("vision"))
                res.update(tokens=toks.numpy(), decode_logits=lg.numpy())
        out[name] = res
    out["params"] = split.jax_params() if case.get("round_trip") else None
    out["params_ref"] = model.jax_params() if case.get("round_trip") \
        else None
    return out


def families(cases: list, model_shards: int = 0) -> list:
    """Each ``_family_case`` on the ``(world // m, m)`` mesh, m =
    ``model_shards`` (default the world)."""
    from repro_torch.fed import mesh as M
    mesh = M.build_client_mesh(-1, model_shards=model_shards or
                               M.world_size())
    return [_family_case(c, mesh) for c in cases]


def collective_counts(seqs: list) -> dict:
    """The model-axis collectives (``all_reduce`` and ``gather`` calls on
    the mesh) of one forward and one backward of an sLSTM, an RG-LRU and
    an mLSTM block (chunk 4) on the ``(1, world)`` mesh, at each sequence
    length of ``seqs``."""
    import torch

    from repro_torch.fed import mesh as M
    from repro_torch.models import rglru as RG
    from repro_torch.models import sharding
    from repro_torch.models import ssm as SSM
    mesh = M.build_client_mesh(-1, model_shards=M.world_size())
    d, n = 32, 4
    calls = {"n": 0}
    for meth in ("all_reduce", "gather"):
        fn = getattr(mesh, meth)

        def counted(*a, _fn=fn, **kw):
            calls["n"] += 1
            return _fn(*a, **kw)
        setattr(mesh, meth, counted)
    gen = torch.Generator().manual_seed(0)
    blocks = {"slstm": (SSM.init_slstm(d, n, generator=gen),
                        lambda p, x: SSM.slstm_forward(p, x, n)),
              "rglru": (RG.init_rglru(d, generator=gen),
                        lambda p, x: RG.rglru_forward(p, x)),
              "mlstm": (SSM.init_mlstm(d, n, generator=gen),
                        lambda p, x: SSM.mlstm_forward(p, x, n, chunk=4))}
    out = {}
    for name, (p, fwd) in blocks.items():
        local = {}
        for k, w in p.items():
            leaves = w.items() if hasattr(w, "items") else [(k, w)]
            for leaf, t in leaves:
                s = M.model_split(leaf, tuple(t.shape), mesh)
                t = t.detach() if s is None else M.model_block(
                    t.detach(), s, mesh)
                local.setdefault(k, {})
                if hasattr(w, "items"):
                    local[k][leaf] = t.clone().requires_grad_(True)
                else:
                    local[k] = t.clone().requires_grad_(True)
        for s in seqs:
            x = torch.randn((2, s, d), generator=gen).requires_grad_(True)
            with sharding.model_parallel(mesh):
                calls["n"] = 0
                y = fwd(local, x)
                n_fwd = calls["n"]
                calls["n"] = 0
                torch.autograd.grad(y.square().sum(), x)
                out[(name, s)] = (n_fwd, calls["n"])
    return out


def dryrun_counts(cases: list) -> list:
    """For each ``(arch spec, mode)`` of ``cases``, one step of batch 2 x
    16 on the ``(1, world)`` mesh over gloo and the dry run's
    ``RecordingMesh`` of this rank on the meta device: the model-axis
    calls each made and the bytes each call handed its backend
    (``launch.hlo_analysis.mesh_calls``), and each run's record in the
    reference's kinds."""
    import torch

    from repro_torch.fed import mesh as M
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    mesh = M.build_client_mesh(-1, model_shards=M.world_size())
    out = []
    for spec, mode in cases:
        cfg = arch_cfg(spec)
        kw = dict(dtype=torch.float32, remat=False)
        with D.recorded(mesh):
            live = D.count_step(cfg, mode, 2, 16, device="cpu", mesh=mesh,
                                **kw)
        rec = D.RecordingMesh(tuple(mesh.shape.values()), ("data", "model"),
                              rank=mesh.rank)
        meta = D.count_step(cfg, mode, 2, 16, mesh=rec, **kw)
        out.append({name: (H.mesh_calls(r["record"]),
                           H.collective_bytes_corrected(r["record"]))
                    for name, r in (("gloo", live), ("meta", meta))})
    return out


def bf16_forward(case: dict) -> dict:
    """The case's forward logits under ``bf16_psum`` on the ``(1,
    world)`` mesh and unsharded (the weights ``case["params"]``, the
    reference's tree, loaded)."""
    import torch

    from repro_torch.fed import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    cfg = arch_cfg(case["cfg"])
    mesh = M.build_client_mesh(-1, model_shards=M.world_size())
    whole = T.Transformer(cfg).load_jax_params(case["params"])
    split = T.Transformer(cfg).shard(mesh).load_jax_params(case["params"])
    kw = {k: torch.as_tensor(v) for k, v in case["inputs"].items()}
    out = {}
    L.set_attention_options(bf16_psum=True)
    try:
        with torch.no_grad():
            out["ref"] = whole(**kw).numpy()
            with sharding.model_parallel(mesh):
                out["mp"] = split(**kw).numpy()
    finally:
        L.set_attention_options()
    return out


def train_sharded(runs: list) -> list:
    """``launch.train.train`` on each run's reduced arch, its seed-0
    weights ``Transformer.shard``-ed over the ``(1, world)`` mesh and
    trained under ``model_parallel``: the losses of each."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.fed import mesh as M
    from repro_torch.launch import train as TR
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    mesh = M.build_mesh((1, M.world_size()), ("data", "model"),
                        device="cpu")
    out = []
    for run in runs:
        cfg = reduced(get_arch(run["arch"]))
        model = T.Transformer(cfg, generator=torch.Generator().manual_seed(
            0)).shard(mesh)
        with sharding.model_parallel(mesh):
            losses, _, _ = TR.train(cfg, model=model, device="cpu",
                                    say=lambda _: None, **run["train"])
        out.append(losses)
    return out


TASKS = {"run": run, "resume": resume, "psum": psum,
         "collectives": collectives, "many": many, "fd_step": fd_step,
         "c11": c11, "families": families,
         "collective_counts": collective_counts,
         "dryrun_counts": dryrun_counts,
         "bf16_forward": bf16_forward, "train_sharded": train_sharded}


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.fed import mesh as M
    torch.set_num_threads(args.threads)
    os.environ.update(RANK=str(args.rank), WORLD_SIZE=str(args.world))
    M.init_distributed("cpu", init_method=f"file://{args.init}")
    assert (dist.get_backend(), dist.get_rank(), dist.get_world_size()) \
        == ("gloo", args.rank, args.world)
    with open(args.spec, "rb") as f:
        spec = pickle.load(f)
    try:
        res = TASKS[spec["task"]](**spec["args"])
        with open(f"{args.out}.{args.rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
