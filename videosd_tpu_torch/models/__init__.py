from videosd_tpu_torch.models.clip_text import CLIP_PRESETS, CLIPTextConfig, CLIPTextModel
from videosd_tpu_torch.models.controlnet import ControlNetModel, controlnet_apply
from videosd_tpu_torch.models.taesd import AutoencoderTiny, TAESDConfig, taesd_decode, taesd_encode
from videosd_tpu_torch.models.unet import (
    UNET_PRESETS,
    UNet2DConditionModel,
    UNetConfig,
    precat_attention_weights,
    unet_apply,
)
from videosd_tpu_torch.models.vae import (
    VAE_PRESETS,
    AutoencoderKL,
    VAEConfig,
    vae_decode,
    vae_encode,
)

__all__ = [
    "AutoencoderKL",
    "AutoencoderTiny",
    "CLIP_PRESETS",
    "CLIPTextConfig",
    "CLIPTextModel",
    "ControlNetModel",
    "TAESDConfig",
    "UNET_PRESETS",
    "UNet2DConditionModel",
    "UNetConfig",
    "VAEConfig",
    "VAE_PRESETS",
    "controlnet_apply",
    "precat_attention_weights",
    "taesd_decode",
    "taesd_encode",
    "unet_apply",
    "vae_decode",
    "vae_encode",
]
