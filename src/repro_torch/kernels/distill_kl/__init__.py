"""Temperature-KL distillation kernels: the fused loss of one distill step
(``ops.kd_kl_loss``) and the per-sample forward and backward
(``ops.kd_kl_per_sample``)."""
