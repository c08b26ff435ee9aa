"""The paper's FEMNIST client model (6,603,710 params): 2-layer CNN, fc 2048."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="paper-femnist", family="paper-cnn", vocab_size=62,
                     optimizer="adam", learning_rate=1e-3)
SMOKE = CONFIG
LOCAL_EPOCHS = 5
BATCH_SIZE = 10
TARGET_ACCURACY = 0.70
