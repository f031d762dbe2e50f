from repro_torch.roofline.analysis import (  # noqa: F401
    H100_SXM,
    HardwareSpec,
    collect_collectives,
    roofline_terms,
)
