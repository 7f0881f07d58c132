"""KMeans-DRE kernels: the fused Lloyd step of the fit (``ops.lloyd_step``)
and the filter's min-distance estimation step (``ops.min_dist_and_mask``)."""
