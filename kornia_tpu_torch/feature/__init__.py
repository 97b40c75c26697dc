"""Local features: detectors, LAFs, descriptors, matchers and the learned
families (counterpart of ``kornia_tpu/feature``)."""
from . import (
    adalam,
    aliked,
    dedode,
    defmo,
    descriptors,
    detector,
    dinov2,
    disk,
    extras,
    hardnet,
    integrated,
    laf,
    lightglue,
    loftr,
    matching,
    mkd,
    orientation,
    responses,
    siftdesc,
    sold2,
    xfeat,
)
from .descriptors import (
    DiscreteSteerer,
    HyNet,
    KeyNet,
    LAFAffineShapeEstimator,
    MKDGradientDescriptor,
    PatchAffineShapeEstimator,
    SOSNet,
    TFeat,
)
from .affnet import AffNet, LAFAffNetShapeEstimator, OriNet
from .detector import ScaleSpaceDetector, detect_features_single_scale
from .hardnet import HardNet
from .integrated import (
    GFTTAffNetHardNet,
    GFTTSIFTFeature,
    HesAffNetHardNet,
    KeyNetAffNetHardNet,
    KeyNetHardNet,
    LAFDescriptor,
    LocalFeature,
    LocalFeatureMatcher,
    SIFTFeature,
    SIFTFeatureScaleSpace,
)
from .multires_detector import KeyNetDetector, MultiResolutionDetector
from .laf import *  # noqa: F401,F403
from .matching import (
    DescriptorMatcher,
    distance_matrix,
    match_fginn,
    match_mnn,
    match_nn,
    match_smnn,
    match_snn,
)
from .adalam import adalam_filter
from .disk import DISK, DISKFeatures
from .lightglue import LightGlue, LightGlueConfig
from .loftr import LoFTR, LoFTRConfig
from .orientation import LAFOrienter, PassLAF, patch_dominant_gradient_orientation
from .xfeat import XFeat
from .sold2 import SOLD2, SOLD2_detector, SOLD2Net
from .dedode import DeDoDe, DeDoDeDescriptor, DeDoDeDetector
from .aliked import ALIKED, ALIKEDNet, SDDH, dkd_detect
from .defmo import DeFMO, EncoderDeFMO, RenderingDeFMO
from .responses import (
    dog_response,
    dog_response_single,
    gftt_response,
    harris_response,
    hessian_response,
)
from .siftdesc import DenseSIFTDescriptor, SIFTDescriptor
from .mkd import (  # noqa: F401
    EmbedGradients,
    ExplicitSpacialEncoding,
    MKDDescriptor,
    MKDGradients,
    SimpleKD,
    VonMisesKernel,
    Whitening,
)
from .extras import (  # noqa: F401
    ALIKEDFeatures,
    BlobDoG,
    BlobDoGSingle,
    BlobHessian,
    CornerGFTT,
    CornerHarris,
    FilterResponseNorm2d,
    GeometryAwareDescriptorMatcher,
    HardNet8,
    InterpolateSparse2d,
    KORNIA_CHECK_LAF,
    LightGlueMatcher,
    PatchDominantGradientOrientation,
    TLU,
    XFeatModel,
    get_laf_descriptors,
    match_adalam,
)
