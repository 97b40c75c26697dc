"""Data augmentation (counterpart of ``kornia_tpu/augmentation``): the 2D
intensity and geometric ops, mix and volumetric ops, the containers (image,
multi-datakey, video, patch), the auto-augmentation policies and ADA.
Parameters are drawn from a ``torch.Generator`` on the input's device, or
injected (``params=``, ``draws=``)."""

from .base import (
    AugmentationBase2D,
    GeometricAugmentationBase2D,
    IntensityAugmentationBase2D,
)
from .container import (
    AugmentationSequential,
    DataKey,
    ImageSequential,
    ManyToManyAugmentationDispather,
    ManyToOneAugmentationDispather,
)
from .geometric import *  # noqa: F401,F403
from .intensity import *  # noqa: F401,F403
from .auto import AutoAugment, RandAugment, TrivialAugment
from .presets import AdaptiveDiscriminatorAugmentation
from .video import PatchSequential, VideoSequential
from .mix import (
    RandomCutMixV2,
    RandomJigsaw,
    RandomMixUpV2,
    RandomMosaic,
    RandomTransplantation,
)
from .volumetric import (
    CenterCrop3D,
    RandomAffine3D,
    RandomCrop3D,
    RandomDepthicalFlip3D,
    RandomEqualize3D,
    RandomHorizontalFlip3D,
    RandomRotation3D,
    RandomVerticalFlip3D,
)
from .base import RigidAffineAugmentationBase2D  # noqa: F401
from .mix import (  # noqa: F401
    MixAugmentationBaseV2,
    PatchMix,
    RandomPatchMix,
    RandomTransplantation3D,
)
from .volumetric import (  # noqa: F401
    AugmentationBase3D,
    GeometricAugmentationBase3D,
    IntensityAugmentationBase3D,
    RandomMotionBlur3D,
    RandomPerspective3D,
    RigidAffineAugmentationBase3D,
)
