"""Configuration: the architecture dataclasses and their presets, and the
training recipe.

Copies of `difashion_tpu/core/config.py`'s model configs and `TrainConfig`
(same fields, same defaults, same presets), kept here so the port imports
nothing of the JAX package. The generation and data configs come with their
slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class UNetConfig:
    """SD2-base UNet2DConditionModel with DiFashion's 8-channel conv_in
    ([latents(4), history latents(4)])."""

    sample_size: int = 64
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    use_linear_projection: bool = True
    fixed_num_heads: Optional[int] = None  # SD1.x: 8 heads per block;
                                           # None -> heads = ch // attention_head_dim
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @staticmethod
    def tiny() -> "UNetConfig":
        """CPU-testable miniature with the same topology."""
        return UNetConfig(
            sample_size=8,
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=32,
            attention_head_dim=16,
            norm_num_groups=8,
        )


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 512

    @property
    def scale_factor(self) -> int:
        """Spatial down-scale: 2**(len(blocks)-1)."""
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(16, 16, 32, 32),
            layers_per_block=1,
            norm_num_groups=8,
            sample_size=64,
        )


@dataclass(frozen=True)
class CLIPTextConfig:
    """SD2-base text encoder (OpenCLIP ViT-H text tower in HF CLIPTextModel form)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23
    num_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=4,
        )


@dataclass(frozen=True)
class MutualEncoderConfig:
    """MutualEncoder MLP: Linear(C*S*S -> hid) -> LeakyReLU -> Dropout(0.1) ->
    Linear(hid -> C*S*S) -> Tanh. The unused `category_embedding` of the
    reference checkpoints is kept as a parameter so they load strictly."""

    latent_channels: int = 4
    latent_size: int = 64
    hid_dim: int = 256
    dropout: float = 0.1
    cate_num: int = 50
    cate_emb_size: int = 64
    keep_unused_category_embedding: bool = True


@dataclass(frozen=True)
class SchedulerConfig:
    """SD2-base PNDM scheduler config."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    skip_prk_steps: bool = True
    set_alpha_to_one: bool = False
    timestep_spacing: str = "leading"


@dataclass(frozen=True)
class ModelConfig:
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    mutual: MutualEncoderConfig = field(default_factory=MutualEncoderConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    @staticmethod
    def sd2_base() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def sd15() -> "ModelConfig":
        """SD-v1.5 family: 768-wide CLIP ViT-L text tower (quick_gelu), conv
        transformer projections, 8 fixed attention heads per block."""
        return ModelConfig(
            unet=UNetConfig(
                cross_attention_dim=768,
                use_linear_projection=False,
                fixed_num_heads=8,
            ),
            text=CLIPTextConfig(
                hidden_size=768,
                intermediate_size=3072,
                num_layers=12,
                num_heads=12,
                hidden_act="quick_gelu",
            ),
        )

    @staticmethod
    def tiny() -> "ModelConfig":
        """A topology-identical miniature for CPU tests: 8x8 latents, 64px images."""
        unet = UNetConfig.tiny()
        vae = VAEConfig.tiny()
        text = CLIPTextConfig.tiny()
        mutual = MutualEncoderConfig(
            latent_channels=4, latent_size=unet.sample_size, hid_dim=32
        )
        return ModelConfig(unet=unet, vae=vae, text=text, mutual=mutual)


@dataclass(frozen=True)
class TrainConfig:
    """The reference's `run_eta0.1.sh` recipe (its `train.py` defaults), as
    the JAX package's `TrainConfig` encodes it."""

    learning_rate: float = 1e-5
    scale_lr: bool = False                # lr *= accumulation * batch * world size
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    use_8bit_adam: bool = False           # block-wise int8 AdamW moments
    max_grad_norm: float = 1.0
    train_batch_size: int = 2             # outfits per device batch
    gradient_accumulation_steps: int = 1
    max_train_steps: int = 20000
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    checkpointing_steps: int = 1000
    checkpoints_total_limit: Optional[int] = None
    seed: int = 123
    use_ema: bool = True
    use_ema_fashion: bool = True
    ema_decay: float = 0.9999
    snr_gamma: Optional[float] = 5.0
    noise_offset: float = 0.0
    prediction_type: Optional[str] = None  # None -> the scheduler's
    # condition-dropout windows (the reference's 0.2, 0.3, 0.2)
    mask_ratio: float = 0.2                # history window start
    coupling_mask_ratio: float = 0.3
    cate_mask_ratio: float = 0.2
    eta: float = 0.1                       # mutual-condition blend weight
    use_history: bool = True
    use_mutual_guidance: bool = True
    mixed_precision: str = "bf16"          # "bf16": torch.autocast over fp32 weights
    gradient_checkpointing: bool = False
    # what a checkpointed block saves when gradient_checkpointing is on
    remat_policy: Optional[str] = "dots_no_batch"   # None | "dots" | "dots_no_batch"
    skip_nonfinite_updates: bool = True    # NaN/Inf gradient guard: hold params, count skips
    dp_size: int = -1                      # -1 => all available devices
    output_dir: str = "ckpt"
    resume_from_checkpoint: Optional[str] = None  # "latest" or an explicit path
