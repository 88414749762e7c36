from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport, roofline_terms,
)
