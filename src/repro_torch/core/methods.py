"""The FD methods of Table III behind one interface.

A ``Method`` bundles the policy choices the paper varies:
  * client_filter  — which proxy logits a client uploads (EdgeFD's
                     KMeans-DRE two-stage filter, Selective-FD's KuLSIF
                     filter, or none);
  * server_filter  — optional server-side tightening (Selective-FD only);
  * sharpen        — DS-FL's temperature sharpening of the fused teacher;
  * data_free      — FKD / PLS exchange class-wise mean logits instead of
                     per-sample proxy logits (no proxy data at all);
  * distill_loss   — temperature KL or MSE on raw logits;
  * server_distill — FedDF: the server trains a student on the ensemble.

``repro_torch.core.protocol`` drives Algorithm 1 generically over a
Method; the records equal ``repro.core.methods.METHODS`` field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.dre import KMeansDRE, KuLSIFDRE


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    client_filter: str = "none"       # none | kmeans | kulsif
    server_filter: bool = False       # Selective-FD entropy filter
    sharpen: Optional[float] = None   # DS-FL ERA temperature
    data_free: bool = False           # FKD / PLS
    count_weighted: bool = False      # PLS: weight class means by counts
    distill_loss: str = "kl"          # kl | mse
    server_distill: bool = False      # FedDF: server-side ensemble student

    def make_dre(self, *, num_centroids: int, threshold: Optional[float],
                 kulsif_threshold: float = 0.05, num_aux: int = 256,
                 sigma: float = 4.0, kernel_backend: Optional[str] = None):
        if self.client_filter == "kmeans":
            return KMeansDRE(num_centroids=num_centroids, threshold=threshold,
                             kernel_backend=kernel_backend)
        if self.client_filter == "kulsif":
            return KuLSIFDRE(threshold=kulsif_threshold, num_aux=num_aux,
                             sigma=sigma, kernel_backend=kernel_backend)
        return None


EDGEFD = Method(name="edgefd", client_filter="kmeans")
FEDMD = Method(name="fedmd")                                   # plain ensemble
FEDED = Method(name="feded", distill_loss="kl")                # central distill
DSFL = Method(name="dsfl", sharpen=0.5)                        # ERA sharpening
FKD = Method(name="fkd", data_free=True)
PLS = Method(name="pls", data_free=True, count_weighted=True)
SELECTIVE_FD = Method(name="selective-fd", client_filter="kulsif",
                      server_filter=True)
INDLEARN = Method(name="indlearn")                             # no collaboration
# FedDF-style ensemble distillation: clients exchange plain ensemble logits
# (like fedmd), and the server also trains a central student on the proxy
# batch against the fused teacher, in a server_distill phase between
# aggregate and distill (repro_torch.fed.scheduler)
SERVER_DISTILL = Method(name="server_distill", server_distill=True)

METHODS = {m.name: m for m in
           (EDGEFD, FEDMD, FEDED, DSFL, FKD, PLS, SELECTIVE_FD, INDLEARN,
            SERVER_DISTILL)}


def get_method(name: str) -> Method:
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; known: {sorted(METHODS)}")
    return METHODS[name]
