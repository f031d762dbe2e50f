"""Scheduling core (copied from ``repro.core``)."""
