"""The port's package exports against the JAX package's.

For the root package and each of its subpackages, every public name of
the JAX package must be bound in the port's twin, unless it is listed in
``STILL_TO_PORT`` (a module family that the port has not reached yet). A
listed name that the port now binds fails too, so the lists shrink as the
port grows. ``RENAMED`` maps a JAX name to the port's name for the same
thing. A submodule counts when the package's ``__init__`` imports it.
Nothing is compiled.
"""

import ast
import importlib
import inspect
import pkgutil

import pytest

import kornia_tpu
import kornia_tpu_torch

# names of JAX modules that are not ported yet, by package
STILL_TO_PORT = {
    "": {
        # the top-level shims, config.py's class and the root helpers
        "KorniaTPUConfig", "color", "enhance", "filters", "morphology",
        "sensors", "eye_like", "vec_like", "pi", "to_jax", "to_numpy",
        "to_tensorflow", "xla_is_available", "is_autocast_enabled",
        "get_cuda_device_if_available", "get_mps_device_if_available",
        "get_cuda_or_mps_device_if_available",
    },
    "contrib": {
        # contrib/detection.py, contrib/visual_prompter.py
        "BoxFiltering", "EdgeDetector", "FaceDetector", "FaceDetectorResult",
        "FaceKeypoint", "ObjectDetector", "SuperResolution", "detection",
    },
    "core": {
        # core/{wrapper,rng,export_mixin}.py, core/module.py's classes
        "ImageModule", "ImageModuleMixIn", "ImageSequential",
        "ONNXExportMixin", "ONNXMixin", "ONNXRuntimeMixin", "TensorWrapper",
        "batch_keys", "export_mixin", "key_iter", "rng", "split_key",
        "unwrap", "wrap", "wrapper",
    },
    "feature": {
        # feature/{xfeat,sold2,dedode,aliked,defmo}.py and extras.py's
        # wrappers of them
        "ALIKED", "ALIKEDFeatures", "ALIKEDNet", "DeDoDe",
        "DeDoDeDescriptor", "DeDoDeDetector", "DeFMO", "EncoderDeFMO",
        "InterpolateSparse2d", "RenderingDeFMO", "SDDH", "SOLD2",
        "SOLD2Net", "SOLD2_detector", "XFeat", "XFeatModel", "aliked",
        "dedode", "defmo", "dkd_detect", "sold2", "xfeat",
    },
    "models": {
        # every model family but the diffusion model and common.py
        "ConvNormAct", "DETRPostProcessor", "DecoderConfig", "DecoderLM",
        "DepthAnything", "DepthAnythingConfig", "DepthAnythingNet",
        "DexiNed", "DropPath", "EfficientViT", "EfficientViTConfig",
        "ImageEncoderHiera", "KimiVLConfig", "KimiVLModel", "LayerNorm2d",
        "MLP", "MaskDecoder3", "MobileViT", "MoonViTConfig", "NaFlex",
        "PaliGemma", "PaliGemmaConfig", "PromptEncoder3", "Prompts",
        "Qwen2VLConfig", "Qwen2VLVisionTransformer", "RRDBNet",
        "RRDBNetBuilder", "RRDBNetConfig", "RTDETR", "RTDETRConfig", "Sam",
        "Sam3", "SamConfig", "SegmentationResults", "SigLip2",
        "SigLip2Config", "SigLip2Exact", "SigLip2ExactConfig",
        "SigLip2Model", "SigLip2TextConfig", "SigLip2TextTower",
        "SigLip2VisionConfig", "SigLip2VisionTower", "SmallSR", "SmolVLM2",
        "TinyViT", "TinyViTConfig", "TransformerEncoderLayer",
        "UNetSegmentor", "VLM", "VLMConfig", "VLMModel", "ViTConfig",
        "VisionTransformer", "VisualPrompter", "YuNet", "depth_anything",
        "dexined", "efficient_vit", "kimi_vl", "mobile_vit", "paligemma",
        "qwen2_vl", "rrdbnet", "rt_detr", "sam", "sam3", "siglip2",
        "siglip2_exact", "siglip_loss", "small_sr",
        "smolvlm2", "structures", "tiny_vit", "vit", "vlm", "yunet",
    },
    "utils": {
        # utils/{compile_cache,debug,export}.py
        "ExportedOp", "assert_finite", "checked", "compile_cache", "debug",
        "enable_compilation_cache", "export", "export_op", "load_exported",
        "save_exported", "trace",
    },
}
# the JAX name → the port's name for the same thing
RENAMED = {"ops": {"pallas_kernels": "kernels"}}

PACKAGES = [""] + sorted(m.name for m in pkgutil.iter_modules(
    kornia_tpu.__path__) if m.ispkg)


def _own_submodules(mod) -> set:
    """The submodules that the package's ``__init__`` itself imports
    (``from . import x``, ``from .x import y``): a submodule that another
    test imported later is an attribute of the package too, and counts
    for neither side."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            if node.module is None:
                names |= {a.asname or a.name for a in node.names}
            else:
                names.add(node.module.split(".")[0])
    return names


def _public(mod):
    own = _own_submodules(mod)
    return {n for n in dir(mod) if not n.startswith("_")
            and (not inspect.ismodule(getattr(mod, n)) or n in own)}


def _pair(pkg):
    suffix = f".{pkg}" if pkg else ""
    return (importlib.import_module("kornia_tpu" + suffix),
            importlib.import_module("kornia_tpu_torch" + suffix))


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "root")
def test_port_binds_the_reference_names(pkg):
    ref, port = _pair(pkg)
    waiting = STILL_TO_PORT.get(pkg, set())
    renamed = RENAMED.get(pkg, {})
    bound = _public(port)
    missing = sorted(n for n in _public(ref) - waiting
                     if renamed.get(n, n) not in bound)
    assert not missing, f"not bound in kornia_tpu_torch.{pkg}: {missing}"
    ported = sorted(waiting & bound)
    assert not ported, f"bound now, take them off STILL_TO_PORT: {ported}"


def test_still_to_port_names_reference_names():
    """Every listed name is a public name of the JAX package (a typo would
    never fail the walk above)."""
    for pkg, names in STILL_TO_PORT.items():
        ref, _ = _pair(pkg)
        assert names <= _public(ref), (pkg, sorted(names - _public(ref)))


def test_the_slam_entry_point_imports():
    from kornia_tpu_torch.slam import two_view_pose
    from kornia_tpu_torch.slam.twoview import two_view_pose as direct
    assert two_view_pose is direct
    assert kornia_tpu_torch.feature.KORNIA_CHECK_LAF is \
        kornia_tpu_torch.core.check_laf
    assert kornia_tpu_torch.feature.CornerHarris.__name__ == "CornerHarris"
