"""Federated runtime: clients, the flat server, the sync round scheduler
and the experiment assembly."""
