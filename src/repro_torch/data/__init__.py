from repro_torch.data.pipeline import SyntheticPipeline  # noqa: F401
