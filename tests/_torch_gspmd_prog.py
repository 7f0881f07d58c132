"""The reference's forward under ``bf16_psum`` on a 2-device CPU mesh.

jax fixes its device count at first use, so a test process with one CPU
device runs this file as a subprocess with
``--xla_force_host_platform_device_count=2`` (the pattern of
``tests/_mesh_parity_prog.py``). For each case of a pickled spec (its
config, the reference's weights as numpy and its inputs) it places the
weights on the ``(1, 2)``
``("data", "model")`` mesh by ``repro.launch.mesh.param_shardings``,
installs ``repro.models.sharding.DEFAULT_RULES`` on that mesh and runs
the jitted ``forward`` with bf16 partial sums, so GSPMD partitions each
``psum_einsum`` and sums the ranks' bf16 products. It writes the
logits, beside the same forward on one device.

    PYTHONPATH=src python tests/_torch_gspmd_prog.py SPEC.pkl OUT.pkl
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys


def main(spec_path: str, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from repro import configs as RC
    from repro.launch import mesh as RM
    from repro.models import layers as RL
    from repro.models import sharding as RS
    from repro.models import transformer as RT

    with open(spec_path, "rb") as f:
        cases = pickle.load(f)
    assert len(jax.devices()) == 2, jax.devices()
    mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ("data", "model"))
    out = []
    for case in cases:
        spec = case["cfg"]
        cfg = RC.reduced(RC.get_arch(spec["arch"]), **spec.get("reduced", {}))
        cfg = dataclasses.replace(cfg, **spec.get("replace", {}))
        params = jax.tree.map(jnp.asarray, case["params"])
        inputs = {k: jnp.asarray(v) for k, v in case["inputs"].items()}

        def fwd(p, kw):
            return RT.forward(p, cfg, **kw)[0]
        RL.set_attention_options(bf16_psum=True)
        try:
            one = np.asarray(jax.jit(fwd)(params, inputs))
            placed = jax.device_put(params, RM.param_shardings(params, mesh))
            rep = NamedSharding(mesh, PartitionSpec())
            RS.set_logical_rules(RS.DEFAULT_RULES, mesh)
            try:
                with mesh:
                    two = np.asarray(jax.jit(
                        fwd, in_shardings=(RM.param_shardings(params, mesh),
                                           rep))(placed, inputs))
            finally:
                RS.set_logical_rules(None, None)
        finally:
            RL.set_attention_options()
        out.append({"one_device": one, "gspmd": two})
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
