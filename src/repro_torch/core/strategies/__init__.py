from repro_torch.core.strategies.base import STRATEGIES, Strategy, build_strategy  # noqa: F401
