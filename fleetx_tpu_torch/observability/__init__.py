"""Metrics, lock sanitizer, flight recorder and SLO registry: the parts
of ``fleetx_tpu/observability`` the serving engine uses, copied."""
