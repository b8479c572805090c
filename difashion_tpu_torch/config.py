"""Configuration: the architecture dataclasses and their presets, the
training recipe, the generation and data settings, and the `Config` tree over
them with its JSON form.

The JAX package's `difashion_tpu/core/config.py` with fields of the port's
own, kept here so the port imports nothing of the JAX package. Every field
the JAX package has is here with its default, its presets and its JSON; the
port adds what the SDXL UNet needs (per-level transformer depth,
the added time / text conditioning, a second text tower and the hidden state
the context takes), each defaulting to the SD behaviour, so the SD presets
are the JAX package's with those fields at their defaults. `from_dict`
ignores keys it does not know, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


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
    # the port's own (SDXL): BasicTransformerBlocks per Transformer2D, one
    # number or one per level (the mid block takes the last level's, the up
    # blocks the levels' in reverse)
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # "text_time": the pooled text embedding and the sinusoidal embedding
    # (addition_time_embed_dim wide) of each time id, concatenated
    # (projection_class_embeddings_input_dim wide: the pooled width + 6 x
    # addition_time_embed_dim, which ModelConfig checks), through Linear,
    # SiLU, Linear and added to the time embedding
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None

    def level_depth(self, level: int) -> int:
        """Transformer blocks per Transformer2D at down level `level`."""
        d = self.transformer_layers_per_block
        return d if isinstance(d, int) else d[level]

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
    # the port's own (SDXL): the width of `text_projection` (no bias) over
    # the final-LayerNorm state at the EOS position, the pooled embedding
    # (None: no projection); and the hidden state the context takes, as
    # transformers indexes `hidden_states` (-2: the penultimate layer's
    # output, before the final LayerNorm), None for the last hidden state
    # after the final LayerNorm
    projection_dim: Optional[int] = None
    context_hidden_state: Optional[int] = None

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
    # the port's own (SDXL): a second text tower; the context is the two
    # towers' contexts concatenated, the pooled embedding this tower's
    text_2: Optional[CLIPTextConfig] = None

    def __post_init__(self):
        """The second tower and the UNet's added conditioning come together,
        and the added embedding's input is the pooled width and six time
        embeddings."""
        unet, text_2 = self.unet, self.text_2
        if (text_2 is None) != (unet.addition_embed_type is None):
            raise ValueError(
                "a second text tower (text_2) and the UNet's added conditioning "
                "(unet.addition_embed_type) come together: "
                f"text_2 is {'set' if text_2 else 'None'}, addition_embed_type is "
                f"{unet.addition_embed_type!r}")
        if text_2 is not None:
            if text_2.projection_dim is None or unet.addition_time_embed_dim is None:
                raise ValueError("the added conditioning needs text_2.projection_dim and "
                                 "unet.addition_time_embed_dim")
            want = text_2.projection_dim + 6 * unet.addition_time_embed_dim
            if unet.projection_class_embeddings_input_dim != want:
                raise ValueError(
                    f"unet.projection_class_embeddings_input_dim is "
                    f"{unet.projection_class_embeddings_input_dim}, not text_2.projection_dim "
                    f"+ 6 x addition_time_embed_dim = {want}")

    @property
    def added_conditioning(self) -> bool:
        """The SDXL conditioning: a second text tower and the UNet's added
        time / text embedding (`__post_init__` holds them together)."""
        return self.text_2 is not None

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

    @staticmethod
    def sdxl_base() -> "ModelConfig":
        """SDXL base 1.0 (stabilityai/stable-diffusion-xl-base-1.0) with
        DiFashion's 8-channel conv_in: 3 levels with 1 / 2 / 10 transformer
        blocks (70 a forward), d = 64 heads, linear projections, a 2048-wide
        context from CLIP ViT-L and OpenCLIP ViT-bigG (each one's
        penultimate state), the added time / text conditioning, 128x128
        latents (1024 px), the VAE at scaling factor 0.13025."""
        return ModelConfig(
            unet=UNetConfig(
                sample_size=128,
                block_out_channels=(320, 640, 1280),
                cross_attention_dim=2048,
                down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                  "CrossAttnDownBlock2D"),
                up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
                transformer_layers_per_block=(1, 2, 10),
                addition_embed_type="text_time",
                addition_time_embed_dim=256,
                projection_class_embeddings_input_dim=2816,
            ),
            vae=VAEConfig(scaling_factor=0.13025, sample_size=1024),
            text=CLIPTextConfig(
                hidden_size=768,
                intermediate_size=3072,
                num_layers=12,
                num_heads=12,
                hidden_act="quick_gelu",
                context_hidden_state=-2,
            ),
            text_2=CLIPTextConfig(
                hidden_size=1280,
                intermediate_size=5120,
                num_layers=32,
                num_heads=20,
                projection_dim=1280,
                context_hidden_state=-2,
            ),
            mutual=MutualEncoderConfig(latent_size=128),
        )

    @staticmethod
    def tiny_xl() -> "ModelConfig":
        """The SDXL topology in miniature for CPU tests: 3 levels with
        unequal per-level depth (1 / 2 / 3), d = 16 heads, the added
        conditioning, two text towers (penultimate contexts, the second's
        pooled projection), 8x8 latents, 64 px images."""
        unet = UNetConfig(
            sample_size=8,
            block_out_channels=(32, 64, 64),
            layers_per_block=1,
            cross_attention_dim=48,
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
            norm_num_groups=8,
            attention_head_dim=16,
            transformer_layers_per_block=(1, 2, 3),
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=16 + 6 * 8,
        )
        text = dataclasses.replace(CLIPTextConfig.tiny(), context_hidden_state=-2,
                                   hidden_act="quick_gelu")
        text_2 = dataclasses.replace(CLIPTextConfig.tiny(), hidden_size=16,
                                     intermediate_size=48, num_layers=3,
                                     projection_dim=16, context_hidden_state=-2)
        return ModelConfig(unet=unet, vae=dataclasses.replace(VAEConfig.tiny(),
                                                              scaling_factor=0.13025),
                           text=text, text_2=text_2,
                           mutual=MutualEncoderConfig(latent_channels=4, latent_size=8,
                                                      hid_dim=32))


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


@dataclass(frozen=True)
class GenerationConfig:
    """The reference's `run_inf4eval.sh` / inf4eval defaults."""

    num_inference_steps: int = 50
    category_guidance_scale: float = 12.0
    hist_guidance_scale: float = 4.0
    mutual_guidance_scale: float = 5.0
    eta: float = 0.1
    scheduler: str = "pndm"               # "pndm" | "ddim" | "dpmpp" (fast serving)
    ddim_eta: float = 0.0
    fitb_batch_size: int = 15
    gor_batch_size: int = 4
    seed: int = 123
    height: int = 512
    width: int = 512


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "polyvore"             # "ifashion" | "polyvore"
    data_path: str = "datasets/polyvore"
    img_folder_path: str = "datasets/polyvore/images"
    img_size: int = 512
    outfit_length: int = 4                # every outfit record has exactly 4 items


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    data: DataConfig = field(default_factory=DataConfig)

    @staticmethod
    def preset_eta01() -> "Config":
        """The canonical training recipe (`run_eta0.1.sh`)."""
        return Config()

    @staticmethod
    def preset_tiny() -> "Config":
        """CPU-runnable miniature for tests."""
        return Config(
            model=ModelConfig.tiny(),
            data=DataConfig(img_size=64),
            generation=dataclasses.replace(
                GenerationConfig(), num_inference_steps=5, height=64, width=64
            ),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        """The inverse of `to_dict`; missing fields keep their defaults, lists
        become tuples."""
        def build(cls, sub):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in sub:
                    continue
                v = sub[f.name]
                sub_cls = _SUBCONFIGS.get(f.name)
                if sub_cls is not None and isinstance(v, dict):
                    v = build(sub_cls, v)
                elif isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
            return cls(**kwargs)

        return build(Config, d)

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config.from_dict(json.loads(s))


_SUBCONFIGS = {
    "unet": UNetConfig,
    "vae": VAEConfig,
    "text": CLIPTextConfig,
    "text_2": CLIPTextConfig,
    "mutual": MutualEncoderConfig,
    "scheduler": SchedulerConfig,
    "model": ModelConfig,
    "train": TrainConfig,
    "generation": GenerationConfig,
    "data": DataConfig,
}
