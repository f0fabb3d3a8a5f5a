from pathtrace_tpu_torch.models.denoise_cnn import DenoiseCNN, ResidualBlock, init_model
from pathtrace_tpu_torch.models.preprocess import preprocess_channels, preprocess_target

__all__ = [
    "DenoiseCNN",
    "ResidualBlock",
    "init_model",
    "preprocess_channels",
    "preprocess_target",
]
