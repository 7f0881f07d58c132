"""PyTorch/CUDA port of the EdgeFD federated-distillation stack.

``repro_torch`` mirrors the subpackage layout and public names of the JAX
package ``repro`` (the reference), so each module's counterpart is easy to
find. It imports ``torch`` and ``numpy`` only. Every Pallas TPU kernel on
the ported path is a hand-written CUDA kernel for Hopper (``sm_90a``) under
``repro_torch.kernels``, next to a plain PyTorch version of the same
function; a wrapper launches the kernel for a CUDA tensor and takes the
plain version only for a tensor on the CPU.

Ported so far: the paper's experiment and its Table III baselines,
``launch.fed_train --method <any of core.methods.METHODS>`` on the loop
engine with sync rounds, a feature-mode dataset and the shared MLP (see
``ROADMAP.md`` for what is still to come).
"""
