from repro_torch.optim.optimizers import (Optimizer, adam, adam_fused,  # noqa: F401
                                          apply_updates, build_optimizer, sgd)
