"""Layers and blocks (counterpart of ``fmdm_tpu/nn``)."""

from fmdm_tpu_torch.nn.layers import (
    Activation,
    BatchNorm,
    Conv,
    ConvND,
    ConvTranspose,
    ConvTransposeND,
    GroupNorm,
    Linear,
    RMSNormND,
    Sequential,
    make_activation,
    make_group_norm,
)
from fmdm_tpu_torch.nn.blocks import (
    DiffusersAttentionND,
    DownsampleND,
    PoolND,
    ResBlockND,
    SpatialCrossAttention,
    SpatialSelfAttention,
    UnPoolND,
    UpsampleND,
)
from fmdm_tpu_torch.nn.unet_blocks import DownBlock2DCompat, UNetMidBlock2DCompat, UpBlock2DCompat
from fmdm_tpu_torch.nn.compat import (
    AvgPoolND,
    ContextBlock,
    LinearQKVAttention,
    MaxPoolND,
    QKVAttention,
    TimestepBlock,
    build_resblock_gn_silu,
    build_resblock_gn_swish,
    build_resblock_rmsnorm_silu,
    build_resblock_rmsnorm_swish,
    zero_module,
)
from fmdm_tpu_torch.nn.vae_modules import (
    Decoder,
    DiagonalGaussian,
    Encoder,
    MagvitDiscriminator,
    MagvitDiscriminatorND,
    PatchDiscriminator,
    VectorQuantizer,
    VectorQuantizerEMA,
)
from fmdm_tpu_torch.nn.losses import (
    PerceptualLoss,
    bce_focal_loss,
    discriminator_hinge_loss,
    focal_loss,
    generator_hinge_loss,
    vq_regularizer,
)
