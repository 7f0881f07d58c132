"""PyTorch/CUDA port of the EdgeFD federated-distillation stack.

``repro_torch`` mirrors the subpackage layout and public names of the JAX
package ``repro`` (the reference), so each module's counterpart is easy to
find. It imports ``torch`` and ``numpy`` only. Every Pallas TPU kernel on
the ported path is a hand-written CUDA kernel for Hopper (``sm_90a``) under
``repro_torch.kernels``, next to a plain PyTorch version of the same
function; a wrapper launches the kernel for a CUDA tensor and takes the
plain version only for a tensor on the CPU.

Ported so far: the paper's experiment and its Table III baselines,
``launch.fed_train --method <any of core.methods.METHODS>`` with sync
rounds on the loop and cohort engines, on feature data (the shared MLP or
the mixed MLP zoo) and image data (the Tables I/II CNN zoo), and
transformer clients on token data on the loop engine (see ``ROADMAP.md``
for what is still to come).
"""
import torch as _torch

# MKL's vector math (VML), which torch's CPU sqrt, exp, log, tanh, ... call
# for float tensors, sets itself up on its first call in a process. Where
# that first call is a parallel one (more than 2048 elements, cut into
# chunks over the intra-op threads), the threads race the set-up, and in a
# few processes in a thousand one chunk comes out of a ~12-bit
# approximation (relative error ~3e-4): the KMeans-DRE calibration's sqrt
# moved its threshold (``tests/_torch_vml_first_call.py``). One serial
# call here, before any of the port's, sets VML up on one thread.
_torch.sqrt(_torch.ones(1))
