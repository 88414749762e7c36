from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticPipeline, make_batch_shape,
)
