"""EdgeFD core: KMeans-DRE, the two-stage client filter, masked-mean
aggregation, distillation losses and the Algorithm-1 protocol, and (as
the reference's ``repro.core`` exports it) the proxy's Gaussian
mechanism."""
from repro_torch.core.privacy import (  # noqa: F401
    gaussian_sigma, make_dp, privatize_proxy)
