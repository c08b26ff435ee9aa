from repro_torch.models.api import build_model, input_specs  # noqa: F401
