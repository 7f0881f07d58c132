"""Scenario: EdgeFD across TRANSFORMER clients on the PyTorch port.

The ``lm_tokens`` dataset makes each client a reduced granite-8b
(``core/fd_trainer.TransformerClientModel``): private shards are
vocab-band token sequences (the LM analogue of strong non-IID), the FD
'sample logit' is the last-position next-token distribution, and
attention runs through ``kernels.dispatch.flash_attention`` (the
hand-written flash-attention kernel on the card, the plain PyTorch
version on the CPU).

The same experiment scales past one device a client: launched over 4
ranks, the cohort runs on a 2-D (clients, model) mesh of (2, 2), each
client's heads, ff and vocab dims split over the model axis
(``repro_torch.fed.mesh``); in a world of one it runs unsharded, as the
reference decides by its device count. Run:

    PYTHONPATH=src python examples_torch/fd_transformers.py [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 4 examples_torch/fd_transformers.py --device cpu

(on one card, four ranks need ``REPRO_DIST_BACKEND=gloo``: NCCL refuses
two ranks on one device).
"""
import argparse
import os

from repro_torch.common.types import FedConfig
from repro_torch.fed import simulator

MESH_RANKS, MODEL_SHARDS = 4, 2
CONFIG = dict(num_clients=4, rounds=3, batch_size=16, proxy_batch=64,
              lr=1e-2, seed=0, engine="cohort")
DATASET = "lm_tokens"
N_TRAIN, N_TEST = 400, 200


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    sharded = world >= MESH_RANKS
    cfg = FedConfig(**CONFIG,
                    num_devices=MESH_RANKS if sharded else 0,
                    model_shards=MODEL_SHARDS if sharded else 0)
    rank0 = int(os.environ.get("RANK", "0")) == 0
    say = print if rank0 else (lambda *_: None)
    say(f"ranks={world}  mesh="
        f"{'2x2 (clients x model)' if sharded else 'unsharded'}")
    res = simulator.run(cfg, DATASET, n_train=N_TRAIN, n_test=N_TEST,
                        device=args.device,
                        progress=lambda log: say(
                            f"round {log.round}: acc={log.mean_acc:.3f} "
                            f"id_frac={log.id_fraction:.2f} "
                            f"distill={log.distill_loss:.3f}"))
    say(f"\nfinal={res.final_acc:.3f} best={res.best_acc:.3f}")
    say("Each transformer client distilled only in-distribution proxy "
        "knowledge: the paper's protocol, clients stacked in one cohort "
        "and, on the mesh, split over the model axis.")
    return res


if __name__ == "__main__":
    main()
