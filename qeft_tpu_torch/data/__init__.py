from qeft_tpu_torch.data.loaders import get_calibration_tokens, get_loaders

__all__ = ["get_calibration_tokens", "get_loaders"]
