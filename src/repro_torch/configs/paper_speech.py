"""The paper's Google Speech client model (67,267 params): 2 conv blocks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="paper-speech", family="paper-cnn", vocab_size=35,
                     optimizer="adam", learning_rate=1e-3)
SMOKE = CONFIG
LOCAL_EPOCHS = 5
BATCH_SIZE = 5
TARGET_ACCURACY = 0.75
