"""The paper's Shakespeare client model (818,402 params): embed8 + 2xLSTM256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="paper-shakespeare", family="paper-lstm",
                     vocab_size=82, optimizer="sgd", learning_rate=0.8)
SMOKE = CONFIG
LOCAL_EPOCHS = 1
BATCH_SIZE = 32
TARGET_ACCURACY = 0.40
