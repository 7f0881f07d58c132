"""``repro_torch.launch.dryrun`` and ``launch.hlo_analysis``: the meta
device's counts against real steps, the ssm family's extrapolation
against the full loop, full-width cells against the reference's analytic
model, and the roofline and record arithmetic.

* A reduced config of each of the six families (a vocab above 1024, so
  ``_EmbedRows``' meta branch runs, audio at its own), train, prefill and
  decode at batch 2 x 16: the meta device's FLOPs (``FlopCounterMode``),
  argument and peak bytes and the bytes its ops move equal a real CPU
  step's, on the same batch shapes, exactly.
* The ssm extrapolation at the mLSTM chunk 4 (the model's default is 256,
  too long for a test): counts at 0 and 1 groups and lengths 8, 12 and
  16, extrapolated to 2 groups at 24, equal the full loop's, exactly, on
  a ``(1, 2)`` recording mesh; its peak is at most the full loop's.
* ``dryrun_one`` at full widths (qwen2.5-3b train_4k, llama3-405b
  decode_32k, xlstm-350m prefill_32k, the last extrapolated at chunk 4):
  keys, ``SKIPS``, and ``analytic_*`` the reference's ``step_cost`` bit
  for bit.
"""
import pytest
import torch

from repro import configs as RC
from repro.launch import analytic as RA
from repro_torch import configs as C
from repro_torch.common.types import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import ssm as SSM

torch.set_num_threads(min(2, torch.get_num_threads()))

FAMILY_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m", "xlstm-350m",
                "recurrentgemma-2b", "hubert-xlarge", "llama-3.2-vision-90b")
CASES = [(a, m) for a in FAMILY_ARCHS for m in ("train", "prefill", "decode")
         if not (a == "hubert-xlarge" and m == "decode")]
B, S = 2, 16
KEYS = ("flops", "argument_bytes", "peak_bytes", "traffic_bytes",
        "param_bytes", "opt_bytes")


def _reduced(arch):
    cfg = C.get_arch(arch)
    return C.reduced(cfg) if cfg.family == "audio" else C.reduced(
        cfg, vocab=2048)


@pytest.mark.parametrize("arch,mode", CASES)
def test_meta_counts_equal_a_real_cpu_step(arch, mode):
    cfg = _reduced(arch)
    data = distinct = None
    if mode != "decode":
        data = {k: v.contiguous() for k, v in
                make_batch_fn(cfg, B, S, seed=1)().items()}
        if "tokens" in data:
            # repeated tokens: the meta count must take the batch's own
            data["tokens"] = data["tokens"] % 5
            distinct = int(torch.unique(data["tokens"]).numel())
    real = D.count_step(cfg, mode, B, S, dtype=torch.float32, device="cpu",
                        data=data)
    meta = D.count_step(cfg, mode, B, S, dtype=torch.float32,
                        distinct=distinct)
    assert real["flops"] > 0
    assert {k: meta[k] for k in KEYS} == {k: real[k] for k in KEYS}


@pytest.fixture
def chunk4(monkeypatch):
    """The mLSTM at chunk 4: the extrapolation's points at 8, 12 and 16."""
    monkeypatch.setitem(SSM.mlstm_forward.__kwdefaults__, "chunk", 4)
    monkeypatch.setattr(SSM, "CHUNK", 4)
    return 4


def test_ssm_extrapolation_equals_the_full_loop(chunk4):
    chunk = chunk4
    cfg = C.reduced(C.get_arch("xlstm-350m"), layers=4, d_model=32,
                    vocab=64)
    points = D.ssm_points()
    assert points == tuple((g, k * chunk) for g in (0, 1) for k in (2, 3, 4))
    shape = InputShape(name="t", seq_len=6 * chunk, global_batch=1,
                       mode="train")
    kw = dict(dtype=torch.float32, device="cpu")
    got = D.rank_counts(cfg, shape, 1, points=points,
                        mesh=D.RecordingMesh((1, 2), ("data", "model"),
                                             device="cpu"), **kw)
    mesh = D.RecordingMesh((1, 2), ("data", "model"), device="cpu")
    full = D.count_step(cfg, "train", 1, shape.seq_len, mesh=mesh, **kw)
    assert got["extrapolated_from"] == [list(p) for p in points]
    assert {k: got[k] for k in KEYS if k != "peak_bytes"} == \
        {k: full[k] for k in KEYS if k != "peak_bytes"}
    assert got["collectives"] == H.collective_bytes_corrected(full["record"])
    assert got["collectives"]["count"] > 0
    assert 0 < got["peak_bytes"] <= full["peak_bytes"]
    assert H.while_trip_counts(got["record"]) == [
        ("blocks", 2), ("mlstm_chunks", 6), ("slstm_time", 6 * chunk)]


FULL = [("qwen2.5-3b", "train_4k"), ("llama3-405b", "decode_32k"),
        ("xlstm-350m", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", FULL)
def test_full_width_cells_and_the_reference_analytic_model(arch, shape,
                                                           chunk4):
    """At full widths; the xLSTM's points at chunk 4 (``chunk4``: 2304
    sLSTM steps at the model's chunk of 256 would take half a minute)."""
    r = D.dryrun_one(arch, shape, verbose=False)
    assert {"arch", "shape", "mesh", "n_chips", "mode", "fsdp",
            "collectives", "memory", "t_compute_s", "t_memory_s",
            "t_collective_s", "bottleneck", "analytic_flops_global",
            "analytic_hbm_bytes_global", "model_flops_total",
            "useful_flops_ratio", "counted_flops_per_rank"} <= set(r)
    assert (r["mesh"], r["n_chips"]) == ("data=16xmodel=16", 256)
    want = RA.step_cost(RC.get_arch(arch), RC.SHAPES[shape],
                        window=D.long_window_for(C.get_arch(arch),
                                                 C.SHAPES[shape]))
    assert r["analytic_flops_global"] == want.flops
    assert r["analytic_hbm_bytes_global"] == want.hbm_bytes
    assert r["counted_flops_per_rank"] > 0
    assert r["collectives"]["count"] > 0
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    shp = C.SHAPES[shape]
    assert r["rank_batch"] == shp.global_batch // 16
    if shp.mode == "train":
        assert r["fsdp"] and r["by_formula"]["collectives"]["count"] > 0
    else:
        assert r["by_formula"]["collectives"]["count"] == 0
    ssm = C.get_arch(arch).family == "ssm"
    assert (r["extrapolated_from"] is not None) == ssm
    assert r["memory"]["peak_is_lower_bound"] == ssm
    if ssm:
        assert dict(r["loops"])["slstm_time"] == shp.seq_len


def test_encoder_decode_cells_are_skipped():
    for shape in ("decode_32k", "long_500k"):
        r = D.dryrun_one("hubert-xlarge", shape, verbose=False)
        assert r == {"arch": "hubert-xlarge", "shape": shape,
                     "skipped": D.SKIPS[("hubert-xlarge", shape)]}


def test_roofline_terms_and_bottleneck():
    analytic = RA.CostModel(flops=2.0e15, hbm_bytes=1.0e12, detail={})
    counted = {"flops": 989 * 10 ** 9, "traffic_bytes": 335 * 10 ** 9}
    r = D.roofline(counted, 0.05, 1.0e9, 256, 1.0e15, analytic)
    assert r["t_compute_s"] == pytest.approx(1e-3)
    assert r["t_memory_s"] == pytest.approx(0.1)
    assert r["t_collective_s"] == 0.05 and r["bottleneck"] == "memory"
    assert r["analytic_t_compute_s"] == 2.0e15 / 256 / D.PEAK_FLOPS
    assert r["useful_flops_ratio"] == 1.0e15 / (989 * 10 ** 9 * 256)
    r32 = D.roofline(counted, 0.0, 0.0, 1, 0.0, analytic,
                     dtype=torch.float32)
    assert r32["t_compute_s"] == counted["flops"] / 67e12
    assert r32["bottleneck"] == "memory"
    assert D.roofline(counted, 1.0, 0.0, 1, 0.0, analytic)["bottleneck"] \
        == "collective"


def test_link_rates_by_node():
    assert D.link_bw((16, 16), ("data", "model"), "model") == D.IB_BW
    assert D.link_bw((16, 16), ("data", "model"), "data") == D.IB_BW
    assert D.link_bw((32, 8), ("data", "model"), "model") == D.NVLINK_BW
    assert D.link_bw((1, 2), ("data", "model"), None) == D.NVLINK_BW


def test_record_arithmetic():
    rec = {"collectives": [("all-reduce", "model", 8, 8),
                           ("all-gather", "model", 4, 64),
                           ("all-reduce", "model", 2, 2)],
           "loops": [{"name": "blocks", "trips": 3, "collectives": []},
                     {"name": "scan", "trips": 5,
                      "collectives": [("all-gather", "model", 1, 16)]}]}
    got = H.collective_bytes_corrected(rec)
    assert got == {"all-gather": 64 + 5 * 16, "all-reduce": 10,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "count": 3 + 5}
    assert set(got) == set(H.COLL_KINDS) | {"count"}
    assert H.while_trip_counts(rec) == [("blocks", 3), ("scan", 5)]
    assert H.mesh_calls(rec) == {"calls": {"all_reduce": 2, "gather": 1},
                                 "bytes": {"all_reduce": 10, "gather": 4}}


def test_recording_mesh_shapes_and_record():
    mesh = D.RecordingMesh((1, 4), ("data", "model"), rank=2, device="cpu")
    assert mesh.coords == (0, 2)
    t = torch.ones(2, 3)
    assert mesh.all_reduce(t, "data") is t            # an axis of one
    assert mesh.all_reduce(t, "model").shape == (2, 3)
    assert mesh.gather(t, "model", dim=1).shape == (2, 12)
    assert mesh.record == [("all-reduce", "model", 24, 24),
                           ("all-gather", "model", 24, 96)]


def test_extrapolate_is_exact_on_affine_by_quadratic_counts():
    def f(g, s):
        return 7 + 3 * s + g * (11 + 5 * s + 2 * s * s)
    pts = {(g, s): {"flops": f(g, s), "argument_bytes": 2 * f(g, s) - s * s,
                    "peak_bytes": 3 * f(g, s),
                    "record": {"collectives": [("all-reduce", "m", 1, 1)]
                               * (1 + g)}}
           for g in (0, 1) for s in (256, 512, 768)}
    out = D.extrapolate(pts, 12, 4096)
    assert out["flops"] == f(12, 4096) and isinstance(out["flops"], int)
    assert out["argument_bytes"] == 2 * f(12, 4096) - 4096 ** 2
    assert out["collectives"]["count"] == 13
    # the peak: the line through the two longest points at one group,
    # plus the argument bytes of the eleven more
    line = 3 * f(1, 768) + (3 * f(1, 768) - 3 * f(1, 512)) * (4096 - 768) \
        // 256
    args = (2 * f(1, 768) - 768 ** 2) + ((2 * f(1, 768) - 768 ** 2)
                                          - (2 * f(1, 512) - 512 ** 2)) \
        * (4096 - 768) // 256
    assert out["peak_bytes"] == line + out["argument_bytes"] - args
    assert D._exact(D._lagrange([0, 3], [0, 1], 1)) == 1 / 3
