"""Deterministic data pipeline (port of `repro.data`)."""
