"""KuLSIF-DRE kernel: the RBF Gram matrix (``ops.rbf_matrix``)."""
