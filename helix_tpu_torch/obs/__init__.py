"""Observability: the metrics registry, flight recorder, traces and SLOs."""
