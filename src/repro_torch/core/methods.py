"""FD methods behind one interface (Table III).

The reference's ``Method`` bundles the policy choices the paper varies
(client filter, server filter, sharpening, data-free exchange, distill
loss, server student). Ported so far: EdgeFD — KMeans-DRE two-stage
client filter, plain masked mean, temperature-KL distillation — so the
record holds only what EdgeFD sets. The reference's other methods raise
``NotImplementedError`` naming the ROADMAP item that brings them (and
with them the policy fields they need).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.dre import KMeansDRE


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    client_filter: str = "kmeans"     # EdgeFD's KMeans-DRE filter

    def make_dre(self, *, num_centroids: int, threshold: Optional[float],
                 kernel_backend: Optional[str] = None) -> KMeansDRE:
        return KMeansDRE(num_centroids=num_centroids, threshold=threshold,
                         kernel_backend=kernel_backend)


EDGEFD = Method(name="edgefd")

METHODS = {m.name: m for m in (EDGEFD,)}
# the reference's other Table III methods, all brought by ROADMAP queue A
# item 4 (with kernel B5 for selective-fd)
NOT_PORTED = ("fedmd", "feded", "dsfl", "fkd", "pls", "selective-fd",
              "indlearn", "server_distill")


def get_method(name: str) -> Method:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"method {name!r} is not ported yet: ROADMAP queue A item 4 "
            "(the other Table III methods)")
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; known: "
                       f"{sorted(METHODS) + sorted(NOT_PORTED)}")
    return METHODS[name]
