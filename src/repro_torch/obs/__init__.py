"""Flight-recorder event bus (``events`` copied from ``repro.obs``)."""
