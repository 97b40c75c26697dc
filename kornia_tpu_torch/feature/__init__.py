"""Local features: detectors, LAFs, descriptors, matchers (counterpart of
``kornia_tpu/feature``; the XFeat, SOLD2, DeDoDe, ALIKED and DeFMO families
are still to port)."""
from . import (
    adalam,
    descriptors,
    detector,
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
    BlobDoG,
    BlobDoGSingle,
    BlobHessian,
    CornerGFTT,
    CornerHarris,
    FilterResponseNorm2d,
    GeometryAwareDescriptorMatcher,
    HardNet8,
    KORNIA_CHECK_LAF,
    LightGlueMatcher,
    PatchDominantGradientOrientation,
    TLU,
    get_laf_descriptors,
    match_adalam,
)
