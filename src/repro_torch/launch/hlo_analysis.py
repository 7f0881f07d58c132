"""Collective traffic and loop trips of one rank's step, from the dry run's
record (the counterpart of ``repro.launch.hlo_analysis``).

The reference parses the compiled HLO: it sums the result bytes of every
collective op, per kind, and multiplies a ``while`` body's by its trip
count, since the text holds a ``lax.scan`` body once. The port has no HLO.
Its record is what ``launch.dryrun``'s recording mesh saw on a rank while
the step ran eagerly:

``{"collectives": [(kind, axis, bytes_in, bytes_out), ...],
"loops": [{"name", "trips", "collectives": [...]}, ...]}``

Each call of the mesh maps onto the reference's kinds:

* ``mesh.all_reduce`` → ``"all-reduce"``;
* ``mesh.gather`` → ``"all-gather"``;
* ``models.sharding.reduce_then_block`` → ``"all-reduce"``, since it is
  one (the whole sum, then this rank's block: gloo has no
  reduce-scatter).

Bytes are result bytes, as the reference counts them: an all-reduce's
tensor, a gather's concatenation. A loop's ``collectives``, where given,
are its body's, recorded once and multiplied by ``trips``. The port's
Python loops (the layers, the sLSTM's time steps, the mLSTM's chunks,
the RG-LRU scan's doubling passes) run every trip, so the dry run gives
them none: their collectives are in the top-level list, and the model
axis puts none inside a loop (``tests/test_torch_mesh_families.py``).
The trips are kept for ``while_trip_counts``. The reference's
``split_computations`` and HLO regexes have no counterpart: there is no
text to parse.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
# the port's mesh calls -> the reference's HLO kinds
MESH_KINDS = {"all_reduce": "all-reduce", "gather": "all-gather"}


def empty_counts() -> Dict[str, int]:
    return {k: 0 for k in COLL_KINDS} | {"count": 0}


def _add(out: dict, calls, times: int = 1) -> None:
    for kind, _axis, _bytes_in, bytes_out in calls:
        out[kind] += times * bytes_out
        out["count"] += times


def collective_bytes_corrected(record: dict) -> dict:
    """Per-kind collective result bytes of one rank's step, and their
    ``"count"``, a loop body's times its trips."""
    out = empty_counts()
    _add(out, record.get("collectives", ()))
    for loop in record.get("loops", ()):
        _add(out, loop.get("collectives", ()), loop["trips"])
    return out


def while_trip_counts(record: dict) -> List[Tuple[str, int]]:
    """[(loop, trips), ...]: each loop of the step and the trips it ran
    (at the cell's full length where the dry run extrapolated)."""
    return [(loop["name"], loop["trips"]) for loop in record.get("loops", ())]


def mesh_calls(record: dict) -> Dict[str, Dict[str, int]]:
    """The mesh's calls and the bytes each handed its backend, by the
    mesh method's name (``all_reduce``, ``gather``): what a counter
    around a real mesh sees."""
    by_kind = {v: k for k, v in MESH_KINDS.items()}
    calls: Dict[str, int] = {}
    sent: Dict[str, int] = {}
    for kind, _axis, bytes_in, _bytes_out in record.get("collectives", ()):
        name = by_kind[kind]
        calls[name] = calls.get(name, 0) + 1
        sent[name] = sent.get(name, 0) + bytes_in
    return {"calls": calls, "bytes": sent}
