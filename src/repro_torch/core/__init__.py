"""EdgeFD core: KMeans-DRE, the two-stage client filter, masked-mean
aggregation, distillation losses and the Algorithm-1 protocol."""
