"""Cost model and discrete-event engine (copied from ``repro.simulator``)."""
