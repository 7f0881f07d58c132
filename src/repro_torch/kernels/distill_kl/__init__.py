"""Temperature-KL distillation kernels: forward and backward
(``ops.kd_kl_per_sample``)."""
