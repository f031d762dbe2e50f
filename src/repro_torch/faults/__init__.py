"""Failure policies (``policies`` copied from ``repro.faults``)."""
