"""The paper's MNIST client model (582,026 params): 2-layer CNN, fc 512."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="paper-mnist", family="paper-cnn", vocab_size=10,
                     optimizer="adam", learning_rate=1e-3)
SMOKE = CONFIG
# paper hyperparameters: 5 local epochs, batch size 10, Adam(1e-3)
LOCAL_EPOCHS = 5
BATCH_SIZE = 10
TARGET_ACCURACY = 0.98
