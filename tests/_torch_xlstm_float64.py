"""How far float32 parts xLSTM's decode from its prefill, against float64.

    PYTHONPATH=src python tests/_torch_xlstm_float64.py [LAYERS ...]

At xlstm-350m's widths (d 1024, 4 heads; the mLSTM's heads 512 wide)
with the vocab cut to 512 and the depth to LAYERS (default 4 12 24),
weights drawn from seed 0: ``decode_demo.prefill_then_decode``'s replay
of a 4 × 16 prompt against its prefill, in float32 and in float64, and
each float32 path against the float64 prefill. The port casts the gates
and states to float32 where the reference does, so the float64 run uses
a copy of the package, made in a temporary directory, with every
``torch.float32`` in ``models/`` and ``launch/decode_demo.py`` turned to
``torch.float64``. Prints one line a depth: the max abs and the relative
Frobenius gaps. Runs on the CPU (~1 min at 24 layers).
"""
import dataclasses
import pathlib
import shutil
import sys
import tempfile

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def run(src, dtype, layers):
    """The prefill's and the replay's logits (float64 copies) from the
    package under ``src``."""
    for name in [k for k in sys.modules if k.startswith("repro_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(src))
    try:
        from repro_torch.configs import get_arch
        from repro_torch.launch import decode_demo
        from repro_torch.models.transformer import Transformer
    finally:
        sys.path.pop(0)
    cfg = dataclasses.replace(get_arch("xlstm-350m"), num_layers=layers,
                              vocab_size=512)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0)
                        ).to(dtype)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, 512, (4, 16)))
    _, prefill, replay = decode_demo.prefill_then_decode(
        model, prompt, 64, 1, return_logits=True)
    return prefill.double(), replay.double()


def gaps(a, b):
    return float((a - b).abs().max()), float((a - b).norm() / b.norm())


def main(argv):
    layers = [int(a) for a in argv] or [4, 12, 24]
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        f64 = pathlib.Path(tmp) / "src"
        shutil.copytree(SRC / "repro_torch", f64 / "repro_torch")
        for path in list((f64 / "repro_torch" / "models").glob("*.py")) + [
                f64 / "repro_torch" / "launch" / "decode_demo.py"]:
            path.write_text(path.read_text().replace("torch.float32",
                                                     "torch.float64"))
        for n in layers:
            p32, r32 = run(SRC, torch.float32, n)
            p64, r64 = run(f64, torch.float64, n)
            print(f"layers {n}: float64 replay - prefill max "
                  f"{gaps(r64, p64)[0]:.3e}; float32 replay - prefill "
                  "max %.3e rel %.3e; float32 prefill - float64 max %.3e "
                  "rel %.3e; float32 replay - float64 max %.3e rel %.3e"
                  % (*gaps(r32, p32), *gaps(p32, p64), *gaps(r32, p64)),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
