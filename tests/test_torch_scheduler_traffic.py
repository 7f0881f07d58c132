"""The full scheduler under traffic against a live reference run:
Selective-FD (KuLSIF reports, the server's entropy filter) under weighted
partial participation. Participants, staleness, the ledger and the trace
exact, losses within rtol 1e-4 (``tests/_torch_parity.py``). Churn,
dropout, bursty arrivals and admission: ``test_torch_scheduler_parity.py``,
beside the edgefd case whose compiled steps they reuse."""
from _torch_parity import assert_logs_match, cohort_config


def test_selective_fd_weighted_partial_matches_reference():
    """Sync rounds priced at measured costs (the simulated fields are then
    host timing, not compared). The iid split gives every client the same
    private-set size, so the reference compiles its KuLSIF fit once."""
    kw = cohort_config("selective-fd", "iid", num_clients=4, rounds=3,
                       participation_fraction=0.5,
                       participation_policy="weighted", staleness_decay=0.5)
    _, port = assert_logs_match(kw)
    assert any(r.mean_staleness > 0.0 for r in port.result.rounds)
