"""How far float32 rounding carries through the token cohort's rounds.

    PYTHONPATH=src python tests/_torch_token_cohort_probe.py ARCH D_MODEL

lm_tokens edgefd strong on the unsharded cohort engine (4 clients, 2
rounds, proxy batch 64, batch 16, lr 1e-2, n_train 200, n_test 100,
``_torch_resume_prog.FIXED_COSTS``), its token clients ``ARCH``'s
reduced config at ``D_MODEL`` wide and vocab 32, as
``tests/test_torch_mesh_families.py`` runs it: once as drawn, once with
every client's initial weights scaled by 1 + 1e-7·N(0, 1) (a seeded
draw). Prints each round's local and distill loss and accuracies for
both, the size of a perturbation two orders of summation leave. Runs on
the CPU (~10 s for xlstm-350m at 32).
"""
import sys

import torch

import _torch_mesh_prog as prog
from _torch_resume_prog import FIXED_COSTS


def main(arch: str, d_model: int) -> None:
    from repro_torch.common.types import FedConfig
    from repro_torch.core.methods import get_method
    from repro_torch.core.protocol import engine_from_config, make_scheduler
    from repro_torch.fed import simulator
    cfg = FedConfig(num_clients=4, rounds=2, proxy_batch=64, batch_size=16,
                    lr=1e-2, seed=0, engine="cohort", round_mode="sync")
    spec = {"arch": arch, "reduced": dict(d_model=d_model, vocab=32)}
    for eps in (0.0, 1e-7):
        clients, server, x_test, y_test = simulator.build_experiment(
            cfg, "lm_tokens", n_train=200, n_test=100, device="cpu",
            transformer_cfg=prog.arch_cfg(spec))
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for c in clients:
                for p in c.params:
                    p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        engine = engine_from_config(clients, cfg)
        engine.learn_dres(cfg.seed)
        sched = make_scheduler(engine, server, get_method(cfg.method), cfg,
                               x_test, y_test, sim_phase_costs=FIXED_COSTS)
        for log in sched.run_rounds(0, cfg.rounds):
            print(f"perturbation {eps:g} round {log.round}: local "
                  f"{log.local_loss!r} distill {log.distill_loss!r} accs "
                  f"{log.accs}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
