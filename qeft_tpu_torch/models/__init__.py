"""Model families of the PyTorch port: llama (gemma on the same topology),
OPT, Phi, Bloom and Falcon, and DeepSeek-V2 (the port's own)."""

from qeft_tpu_torch.models.bloom import BLOOM_PRESETS, BloomConfig
from qeft_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_PRESETS, DeepseekV2Config
from qeft_tpu_torch.models.falcon import FALCON_PRESETS, FalconConfig
from qeft_tpu_torch.models.llama import LLAMA_PRESETS, LlamaConfig
from qeft_tpu_torch.models.opt import OPT_PRESETS, OPTConfig
from qeft_tpu_torch.models.phi import PHI_PRESETS, PhiConfig

__all__ = ["BLOOM_PRESETS", "BloomConfig", "DEEPSEEK_V2_PRESETS", "DeepseekV2Config", "FALCON_PRESETS", "FalconConfig", "LLAMA_PRESETS",
           "LlamaConfig", "OPT_PRESETS", "OPTConfig", "PHI_PRESETS", "PhiConfig"]
