"""Phase-by-phase lockstep of an image run: the port against the JAX
reference and a float64 witness, from the same state.

The port runs a whole experiment on the CPU (its own dataset draw and
initial weights). Before each client's local-training or distillation
phase, the client's state — parameters, momentum, the batch-order stream
and the phase's inputs — is handed to two more runs of the same phase:
the reference's jitted step functions (``repro.fed.client.Client``) in
float32, and the port's model in float64 with the same formulas (CE, and
T²·KL with the teacher's softmax). After the phase each run's parameters
are compared, and one line a phase gives the three mean losses and the
largest relative parameter gaps (per tensor, max |a − b| / max |b|):
port − float64, reference − float64 and port − reference. A phase whose
port and reference gaps to float64 are alike, and whose port − reference
gap is of the same size, differs by float32 rounding alone. The first
phase with a non-finite step loss in any run gets its step losses side
by side, and the run stops after it. A phase whose largest gap exceeds
1e-4 is run three more times in float64, each from a start moved by one
float32 rounding: their gaps to the float64 run are the phase's own
sensitivity to rounding; then the phase is replayed step by step in
float32 and float64, and at the first step after which they are more
than 1e-4 apart the script lists the ReLU inputs that change sign and
the max-pool windows that choose another element between the two runs'
parameters before that step (both evaluated in float64).

    PYTHONPATH=src python tests/_torch_image_divergence.py \
        mnist_like edgefd strong 60000 10000 3 [port|reference]

(10 clients, proxy batch 512, seed 0; about 2 minutes at that size on
eight CPU cores.) ``port`` (the default) runs the port's own draw and
initial weights; ``reference`` first runs the reference on its own draw
and then the port from the reference's arrays, initial weights and
k-means seeds, as the parity harness does (``tests/_torch_parity.py``),
and prints both runs' round logs.
"""
from __future__ import annotations

import copy
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.fed.client import Client as RefClient  # noqa: E402
from repro.models.cnn import get_client_model as ref_get_client_model  # noqa: E402,E501
from repro.optim.optimizers import sgd as ref_sgd  # noqa: E402
from repro_torch.common.types import FedConfig  # noqa: E402
from repro_torch.core.protocol import run_experiment  # noqa: E402
from repro_torch.data.synthetic import dataset_from_arrays  # noqa: E402
from repro_torch.fed import simulator  # noqa: E402
from repro_torch.fed.batching import epoch_batches  # noqa: E402
from repro_torch.fed.client import Client  # noqa: E402


def to_reference(tensors, model, momentum: bool = False) -> list:
    """A port CNN's parameter-shaped tensors (parameters or momentum) as
    the reference's layer list: conv ``w`` OIHW → HWIO, dense as it is,
    BatchNorm's ``mean``/``var`` from the model's buffers (zero for a
    momentum list, whose buffers have no gradient)."""
    it = iter(tensors)
    out = []
    for layer in model.layers:
        names = [n for n, _ in layer.named_parameters()]
        vals = {n: next(it).detach().double().numpy() for n in names}
        if "w" in vals and vals["w"].ndim == 4:
            vals["w"] = vals["w"].transpose(2, 3, 1, 0)
        for n, buf in layer.named_buffers():
            vals[n] = np.zeros(buf.shape) if momentum else buf.numpy()
        out.append({n: jnp.asarray(v, jnp.float32) for n, v in vals.items()})
    return out


def from_reference(params, model) -> list:
    """The reference's layer list as the port's parameter order."""
    out = []
    for layer, p in zip(model.layers, params):
        for n, _ in layer.named_parameters():
            v = np.asarray(p[n], np.float64)
            out.append(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
    return out


def gap(a, b) -> float:
    """Largest per-tensor max |a − b| / max |b| (inf if a is not finite)."""
    worst = 0.0
    for x, y in zip(a, b):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if not np.isfinite(x).all() or not np.isfinite(y).all():
            return math.inf
        worst = max(worst, float(np.abs(x - y).max()
                                 / max(np.abs(y).max(), 1e-30)))
    return worst


def ce(logits, y):
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.take_along_dim(logp, y[:, None], -1)[:, 0])


def kl(logits, teacher, w, t):
    teacher, w = teacher.to(logits.dtype), w.to(logits.dtype)
    sp = torch.log_softmax(logits / t, -1)
    tlogp = torch.log_softmax(teacher / t, -1)
    v = torch.sum(torch.exp(tlogp) * (tlogp - sp), -1) * (t * t)
    return torch.sum(v * w) / torch.clamp_min(torch.sum(w), 1.0)


def replay(model, mu, rng_state, x, loss_fn, n, epochs, bs, lr,
           dtype=torch.float64, perturb_seed=None, keep=False):
    """The phase on a copy of ``model`` in ``dtype`` with SGD momentum
    0.9: (parameters after it, step losses, and with ``keep`` each step's
    (batch, parameters before it, parameters after it)). With
    ``perturb_seed`` every starting parameter is first moved by one
    float32 rounding (relative 2^-24, random sign)."""
    m = copy.deepcopy(model).to(dtype).train(True)
    params = list(m.parameters())
    if perturb_seed is not None:
        g = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in params:
                sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                p.mul_(1 + sign.to(dtype) * 2.0 ** -24)
    mu = [v.detach().to(dtype).clone() for v in mu]
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    losses, trace = [], []

    def now():
        return [p.detach().numpy().copy() for p in params]
    for _ in range(epochs):
        for idx in epoch_batches(rng.permutation(n), bs):
            idx = torch.as_tensor(np.asarray(idx))
            before = now() if keep else None
            loss = loss_fn(m(x[idx].to(dtype)), idx)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, v, g in zip(params, mu, grads):
                    v.mul_(0.9).add_(g)
                    p.sub_(lr * v)
            losses.append(float(loss.detach()))
            if keep:
                trace.append((idx, before, now()))
    return now(), losses, trace


def decisions(model, params, xb) -> list:
    """Each layer's ReLU input (conv and hidden dense layers) and max-pool
    choices on the batch ``xb``, in float64 from ``params``."""
    m = copy.deepcopy(model).double()
    with torch.no_grad():
        for p, v in zip(m.parameters(), params):
            p.copy_(torch.as_tensor(v))
        out, h = [], xb.double().permute(0, 3, 1, 2)
        for i, layer in enumerate(m.layers):
            if hasattr(layer, "padding"):               # conv block
                z = F.conv2d(h, layer.w, layer.b, padding=layer.padding)
                out.append((i, "conv ReLU", z))
                h = torch.relu(z)
                if layer.pool:
                    h, choice = F.max_pool2d(h, 2, return_indices=True)
                    out.append((i, "max-pool", choice))
            elif hasattr(layer, "relu"):                # dense
                if h.ndim == 4:
                    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                z = h @ layer.w + layer.b
                if layer.relu:
                    out.append((i, "dense ReLU", z))
                h = torch.relu(z) if layer.relu else z
            else:                                       # BatchNorm
                h = layer(h)
    return out


def first_parting(model, x, t32, t64) -> str:
    """Where a float32 replay leaves the float64 one: the first step after
    which their parameters are more than 1e-4 apart, and the decisions
    that differ between the two runs' parameters before that step."""
    for s, ((idx, a0, a1), (_, b0, b1)) in enumerate(zip(t32, t64)):
        if gap(a1, b1) <= 1e-4:
            continue
        found = []
        for (i, kind, za), (_, _, zb) in zip(
                decisions(model, a0, x[idx]), decisions(model, b0, x[idx])):
            if kind == "max-pool":
                moved = int((za != zb).sum())
                if moved:
                    found.append(f"layer {i} {kind}: {moved} windows "
                                 "choose another element")
                continue
            flip = (za > 0) != (zb > 0)
            if flip.any():
                found.append(
                    f"layer {i} {kind}: {int(flip.sum())} sign flips, input "
                    f"up to {za[flip].abs().max().item():.3e} (float32 run) "
                    f"/ {zb[flip].abs().max().item():.3e} (float64 run), "
                    f"layer scale {zb.abs().max().item():.3e}")
        return (f"step {s} (gap before it {gap(a0, b0):.3e}, after it "
                f"{gap(a1, b1):.3e}); decisions that differ there: "
                + ("; ".join(found) or "none"))
    return "the runs stay within 1e-4"


def main(argv) -> int:
    dataset, method, scenario = argv[:3]
    n_train, n_test, rounds = map(int, argv[3:6])
    draw = argv[6] if len(argv) > 6 else "port"
    kw = dict(num_clients=10, rounds=rounds, method=method,
              scenario=scenario, seed=0, kernel_backend="jnp",
              round_mode="sync", zoo="shared", proxy_batch=512)
    cfg = FedConfig(**kw)
    if draw == "reference":
        # the reference's own run, then the port from its draw, initial
        # weights and k-means seeds (the parity harness's injection)
        from _torch_parity import run_reference
        ref = run_reference(kw, dataset, n_train, n_test)
        for r in ref.result.rounds:
            print(f"reference round {r.round}: acc {r.mean_acc:.5f} local "
                  f"{r.local_loss:.6f} distill {r.distill_loss:.6f}",
                  flush=True)
        ds = ref.dataset
        clients, server, x_test, y_test = simulator.build_experiment(
            cfg, device="cpu", dataset=dataset_from_arrays(
                ds.x, ds.y, ds.x_test, ds.y_test, ds.num_classes),
            init_params=ref.params, kmeans_inits=ref.kmeans_inits,
            kulsif_aux=ref.kulsif_aux)
    else:
        clients, server, x_test, y_test = simulator.build_experiment(
            cfg, dataset, n_train=n_train, n_test=n_test, device="cpu")
    img = "mnist" if x_test.shape[1] == 28 else "cifar10"
    refs = {}
    for c in clients:
        spec = ref_get_client_model(c.cid, img)[0]
        refs[c.cid] = RefClient(
            c.cid, spec.apply, to_reference(c.params, c.model),
            ref_sgd(cfg.lr), c.x, c.y, None, num_classes=c.num_classes,
            temperature=cfg.temperature, distill_loss="kl", seed=cfg.seed,
            kernel_backend="jnp")
    calls = {}
    print("cid phase call | mean loss port / reference / float64 | "
          "param gap port-f64 / reference-f64 / port-reference", flush=True)

    def lockstep(client, phase, run_port, run_ref, loss_fn, n, epochs, bs,
                 x):
        key = (client.cid, phase)
        call = calls.get(key, 0)
        calls[key] = call + 1
        rc = refs[client.cid]
        rng_state = copy.deepcopy(client.rng.bit_generator.state)
        model0 = copy.deepcopy(client.model)
        mu0 = [v.clone() for v in client.opt_state["mu"]]
        rc.params = to_reference(client.params, client.model)
        rc.opt_state = {"mu": to_reference(mu0, client.model, True),
                        "step": jnp.zeros((), jnp.int32)}
        rc.rng.bit_generator.state = copy.deepcopy(rng_state)
        p64, l64, _ = replay(model0, mu0, rng_state, x, loss_fn, n, epochs,
                             bs, cfg.lr)
        ref_losses = []
        orig = rc._distill_step if phase == "distill" else rc._train_step

        def keep(*a):
            out = orig(*a)
            ref_losses.append(float(out[2]))
            return out
        if phase == "distill":
            rc._distill_step = keep
        else:
            rc._train_step = keep
        try:
            run_ref(rc)
        finally:
            if phase == "distill":
                rc._distill_step = orig
            else:
                rc._train_step = orig
        port_losses = []
        orig_step = client._step

        def step(loss):
            v = orig_step(loss)
            port_losses.append(v)
            return v
        client._step = step
        try:
            out = run_port()
        finally:
            del client._step
        port = [p.detach().numpy() for p in client.params]
        ref = from_reference(rc.params, client.model)
        gaps = (gap(port, p64), gap(ref, p64), gap(port, ref))
        print(f"{client.cid} {phase} {call} | {np.mean(port_losses):.6g} / "
              f"{np.mean(ref_losses):.6g} / {np.mean(l64):.6g} | "
              + " / ".join(f"{v:.3e}" for v in gaps), flush=True)
        if max(gaps) > 1e-4:
            spread = [gap(replay(model0, mu0, rng_state, x, loss_fn, n,
                                 epochs, bs, cfg.lr, perturb_seed=k)[0], p64)
                      for k in range(3)]
            print(f"  float64 from starts moved by one float32 rounding: "
                  f"param gap to float64 " + " / ".join(
                      f"{v:.3e}" for v in spread), flush=True)
            # the phase once more in float32 and float64, step by step
            _, _, t64 = replay(model0, mu0, rng_state, x, loss_fn, n, epochs,
                               bs, cfg.lr, keep=True)
            p32, _, t32 = replay(model0, mu0, rng_state, x, loss_fn, n,
                                 epochs, bs, cfg.lr, torch.float32, keep=True)
            print(f"  float32 replay (gap to the port's phase "
                  f"{gap(p32, port):.3e}) parts from float64 at "
                  + first_parting(model0, x, t32, t64), flush=True)
        runs = {"port": port_losses, "reference": ref_losses,
                "float64": l64}
        if not all(map(math.isfinite, port_losses + ref_losses + l64)):
            print(f"non-finite step loss in client {client.cid}'s {phase} "
                  f"call {call}; step losses:", flush=True)
            for name, ls in runs.items():
                print(f"  {name}: " + " ".join(f"{v:.6g}" for v in ls),
                      flush=True)
            raise SystemExit(0)
        return out

    orig_local, orig_distill = Client.local_train, Client.distill

    def local_train(self, epochs, bs):
        return lockstep(
            self, "local", lambda: orig_local(self, epochs, bs),
            lambda rc: rc.local_train(epochs, bs),
            lambda logits, idx: ce(logits, self._y[idx]), len(self.y),
            epochs, bs, self._x)

    def distill(self, x, teacher, weight, epochs, bs):
        return lockstep(
            self, "distill",
            lambda: orig_distill(self, x, teacher, weight, epochs, bs),
            lambda rc: rc.distill(x.numpy(), teacher.numpy(),
                                  weight.numpy(), epochs, bs),
            lambda logits, idx: kl(logits, teacher[idx], weight[idx],
                                   cfg.temperature),
            len(x), epochs, bs, x)

    Client.local_train, Client.distill = local_train, distill
    res = run_experiment(clients, server, method, cfg, x_test, y_test)
    for r in res.rounds:
        print(f"port round {r.round}: acc {r.mean_acc:.5f} local "
              f"{r.local_loss:.6f} distill {r.distill_loss:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
