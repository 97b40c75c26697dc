"""Models (counterpart of ``kornia_tpu/models``). Ported so far: the
building blocks of ``common.py``; the detection and dense-prediction
families (RT-DETR, YuNet, DexiNed, RRDBNet, SmallSR with the UNet
segmentor, Depth Anything); the latent-diffusion dissolving model that
``augmentation.RandomDissolving`` builds. The SAM family, the ViT
backbones and the vision-language models are still to port."""
from . import common  # noqa: F401
from .common import (MLP, ConvNormAct, DropPath, LayerNorm2d,
                     TransformerEncoderLayer)
from .rt_detr import DETRPostProcessor, RTDETR, RTDETRConfig
from .small_sr import SmallSR, UNetSegmentor
from .depth_anything import (DepthAnything, DepthAnythingConfig,
                             DepthAnythingNet)
from .rrdbnet import RRDBNet, RRDBNetBuilder, RRDBNetConfig
from .diffusion import (AutoencoderKL, DDIMSchedule, DiffusionConfig,
                        StableDiffusionDissolving, UNet2dCondition)
from .dexined import DexiNed
from .yunet import YuNet
