"""The port's public signatures against the JAX package's.

For every public function and class of ``kornia_tpu_torch`` that has a
same-named twin in the same module of ``kornia_tpu``, the parameter names
(of ``__init__`` for a class) must be the twin's, in the twin's order, so
that a positional call binds as it does in the reference. Only these
differences are allowed:

- ``key`` → ``generator`` (``torch.Generator`` in the place of a
  ``jax.random`` key);
- keyword-only ``gumbel`` (RANSAC's injected sampling noise) or ``draws``
  (the scene generator's injected normal draws), after the twin's
  parameters;
- ``use_pallas`` → ``streaming``, ``pallas_mode`` → ``patch_mode``;
- a trailing ``device``, where the twin has none.

Names that the JAX module does not define itself, but re-exports from
another library, have no twin.
"""

import importlib
import inspect
import pkgutil

import pytest

import kornia_tpu_torch

_RENAMES = {"key": "generator", "use_pallas": "streaming",
            "pallas_mode": "patch_mode"}
_INJECTED = ("gumbel", "draws")


def _public(module):
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_"):
            continue
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and \
                getattr(obj, "__module__", None) == module.__name__:
            yield name, obj


def _twins():
    pairs = []
    for info in pkgutil.walk_packages(kornia_tpu_torch.__path__,
                                      "kornia_tpu_torch."):
        port = importlib.import_module(info.name)
        try:
            ref = importlib.import_module(
                "kornia_tpu" + info.name[len("kornia_tpu_torch"):])
        except ModuleNotFoundError:
            continue  # a module of the port's own (kernels, convert, sort)
        for name, obj in _public(port):
            twin = getattr(ref, name, None)
            # a name the JAX module re-exports from elsewhere (jax.sharding's
            # Mesh, NamedSharding, PartitionSpec) has no reference signature
            if twin is not None and getattr(
                    twin, "__module__", "").startswith("kornia_tpu"):
                pairs.append(pytest.param(obj, getattr(ref, name),
                                          id=f"{info.name[17:]}.{name}"))
    return pairs


def _params(obj):
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return [p for p in inspect.signature(fn).parameters.values()
            if p.name != "self"]


@pytest.mark.parametrize("port,ref", _twins())
def test_signature_follows_the_reference(port, ref):
    got = _params(port)
    got = [p for p in got if not (p.kind is p.KEYWORD_ONLY
                                  and p.name in _INJECTED)]
    want = [_RENAMES.get(p.name, p.name) for p in _params(ref)]
    # a trailing device of the port's own (io.load_image's is the twin's)
    if got and got[-1].name == "device" and want[-1:] != ["device"]:
        got = got[:-1]
    assert [p.name for p in got] == want


def test_the_twins_are_found():
    """The walk reaches every ported module with a twin, this slice's
    included."""
    ids = {p.id for p in _twins()}
    assert len(ids) >= 883
    for name in ("ops.warp.resize", "ops.filters.spatial_gradient",
                 "feature.descriptors.TFeat", "feature.descriptors.HyNet",
                 "feature.descriptors.LAFAffineShapeEstimator",
                 "feature.siftdesc.DenseSIFTDescriptor",
                 "feature.mkd.MKDDescriptor", "feature.mkd.Whitening",
                 "feature.adalam.adalam_filter",
                 "feature.lightglue.LightGlue", "feature.disk.DISK",
                 "feature.extras.HardNet8", "feature.extras.LightGlueMatcher",
                 "feature.extras.get_laf_descriptors",
                 "feature.detector.ScaleSpaceDetector",
                 "geometry.ransac.ransac", "geometry.ransac.RANSAC",
                 "tracking.planar_tracker.HomographyTracker",
                 "feature.hardnet.HardNet", "feature.affnet.AffNet",
                 "feature.affnet.OriNet",
                 "feature.affnet.LAFAffNetShapeEstimator",
                 "feature.orientation.PassLAF",
                 "feature.integrated.GFTTAffNetHardNet",
                 "feature.integrated.HesAffNetHardNet",
                 "feature.loftr.LoFTR", "feature.loftr.LoFTRConfig",
                 "feature.loftr.loftr_backbone",
                 "ops.color.rgb_to_grayscale",
                 "feature.descriptors.KeyNet",
                 "feature.multires_detector.MultiResolutionDetector",
                 "feature.multires_detector.KeyNetDetector",
                 "feature.integrated.KeyNetHardNet",
                 "feature.integrated.KeyNetAffNetHardNet",
                 "geometry.camera.PinholeCamera",
                 "geometry.camera.StereoCamera",
                 "geometry.camera.undistort_points_kannala_brandt",
                 "geometry.calibration.undistort_image",
                 "geometry.depth.warp_frame_depth",
                 "geometry.depth.DepthWarper", "ops.warp.remap",
                 "ops.filters.box_blur",
                 "core.grid.normalize_pixel_coordinates",
                 "contrib.stereo.stereo_matching",
                 "contrib.image_stitching.ImageStitcher",
                 "parallel.mesh.make_mesh", "parallel.mesh.shard_batch",
                 "parallel.dist_ba.distributed_bundle_adjust",
                 "parallel.dist_ba.distributed_bundle_adjust_sparse",
                 "parallel.dist_ba.build_sharded_point_tables",
                 "parallel.dist_posegraph.partition_pose_graph",
                 "parallel.dist_posegraph.distributed_pose_graph",
                 "parallel.dist_posegraph.distributed_pose_graph_streaming",
                 "utils.elastic.run_restartable",
                 "utils.elastic.latest_checkpoint",
                 "utils.checkpoint.save_checkpoint",
                 "utils.checkpoint.load_checkpoint",
                 "feature.loftr.loftr_coarse_context_parallel",
                 "geometry.registration.ImageRegistrator",
                 "geometry.registration.Homography",
                 "geometry.epipolar.find_essential",
                 "geometry.epipolar.random_intrinsics",
                 "geometry.epipolar.decompose_essential_matrix_no_svd",
                 "geometry.subpix.iterative_quad_interp3d",
                 "geometry.subpix.conv_soft_argmax2d",
                 "geometry.conversions.ARKitQTVecs_to_ColmapQTVecs",
                 "geometry.linalg.point_line_distance",
                 "geometry.pose.NamedPose",
                 "geometry.pointcloud.save_pointcloud_ply",
                 "geometry.Affine", "geometry.AdaptiveQuadInterp3d",
                 "losses.losses.ms_ssim_loss",
                 "losses.losses.hausdorff_distance_loss",
                 "losses.mutual_information.MILossFromRef2D",
                 "losses.mutual_information.mutual_information_loss",
                 "metrics.metrics.mean_average_precision",
                 "metrics.metrics.confusion_matrix",
                 "contrib.ops.KMeans", "contrib.ops.kmeans",
                 "contrib.ops.distance_transform",
                 "contrib.BoxMotTracker",
                 "augmentation.base.AugmentationBase2D",
                 "augmentation.intensity.RandomPlanckianJitter",
                 "augmentation.intensity.RandomDissolving",
                 "augmentation.geometric.RandomElasticTransform",
                 "augmentation.geometric.PadTo",
                 "augmentation.container.AugmentationSequential",
                 "augmentation.container.ManyToOneAugmentationDispather",
                 "augmentation.mix.RandomTransplantation3D",
                 "augmentation.volumetric.RandomPerspective3D",
                 "augmentation.video.VideoSequential",
                 "augmentation.video.PatchSequential",
                 "augmentation.video.PatchParamItem",
                 "augmentation.auto.AutoAugment",
                 "augmentation.auto.Operation",
                 "augmentation.presets.AdaptiveDiscriminatorAugmentation",
                 "models.common.nchw_to_nhwc",
                 "models.diffusion.StableDiffusionDissolving",
                 "models.diffusion.UNet2dCondition",
                 "models.diffusion.DDIMSchedule",
                 "feature.xfeat.XFeat", "feature.xfeat.xfeat_model",
                 "feature.aliked.ALIKED", "feature.aliked.SDDH",
                 "feature.aliked.dkd_detect", "feature.dinov2.DinoV2ViT",
                 "feature.dedode.DeDoDe", "feature.dedode.DeDoDeDescriptorG",
                 "feature.dedode.sample_keypoints", "feature.sold2.SOLD2",
                 "feature.sold2.detect_line_segments",
                 "feature.sold2.refine_segments_perturb",
                 "feature.defmo.DeFMO", "feature.defmo.RenderingDeFMO",
                 "feature.extras.XFeatModel",
                 "feature.extras.InterpolateSparse2d",
                 "models.common.ConvNormAct",
                 "models.common.TransformerEncoderLayer",
                 "models.rt_detr.RTDETR", "models.rt_detr.DETRPostProcessor",
                 "models.yunet.prior_boxes", "models.yunet.decode",
                 "models.dexined.DexiNed", "models.rrdbnet.RRDBNetBuilder",
                 "models.small_sr.SmallSR", "models.small_sr.UNetSegmentor",
                 "models.depth_anything.DepthAnything",
                 "contrib.detection.ObjectDetector",
                 "contrib.detection.FaceDetector",
                 "contrib.detection.EdgeDetector", "contrib.SuperResolution",
                 "tracking.bytetrack.BoxTracker"):
        assert name in ids
