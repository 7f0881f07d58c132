"""Import shim, as the reference's ``repro.launch.serve``: the token-decode
demo lives in ``repro_torch.launch.decode_demo`` and the federated service
in ``repro_torch.launch.fed_serve``. This module re-exports the demo's
public surface and stays runnable for old command lines."""
from repro_torch.launch.decode_demo import main, prefill_then_decode  # noqa: F401

if __name__ == "__main__":
    main()
