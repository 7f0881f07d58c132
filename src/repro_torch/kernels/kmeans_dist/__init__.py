"""KMeans-DRE kernels: the fused Lloyd step (``ops.lloyd_step``)."""
