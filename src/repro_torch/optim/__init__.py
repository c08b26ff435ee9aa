from repro_torch.optim.optimizers import (Optimizer, adafactor,  # noqa: F401
                                          adam, adam_fused, apply_updates,
                                          build_optimizer, momentum, sgd)
