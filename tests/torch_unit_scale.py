"""Seeded weights rescaled so that two nets' outputs are O(1).

The reference init functions leave some nets' outputs far below 1: YuNet's
Xavier draws through 13 depthwise-pointwise units give loc and iou near
1e-9 and conf 0.5 exactly, and RRDBNet's basicsr init (Kaiming scaled by
0.1) gives outputs near 1e-5. A comparison at 1e-4 of such an output
holds nothing, so the parity legs, the card legs and ``chip_smoke.py``
step 19 give both sides these rescaled weights.
Each rule is element-wise by name, so it serves the JAX package's HWIO
dicts and the port's OIHW ones alike (numpy arrays or tensors).
"""

YUNET_RUNNING_VAR = 0.02   # each batch norm then gains about 7x
YUNET_HEAD_GAIN = 8.0      # the heads' last depthwise convolutions
RRDBNET_GAIN = 10.0        # undoes basicsr's 0.1


def yunet_unit_scale(params):
    """YuNet's parameters with every running variance set to
    YUNET_RUNNING_VAR and each head's last (unnormalised) depthwise
    convolution scaled by YUNET_HEAD_GAIN."""
    out = {}
    for k, v in params.items():
        if k.endswith(".running_var"):
            v = v * 0 + YUNET_RUNNING_VAR
        elif k.startswith("head.") and k.endswith(".conv2.conv2.weight"):
            v = v * YUNET_HEAD_GAIN
        out[k] = v
    return out


def rrdbnet_unit_scale(params):
    """RRDBNet's parameters with every convolution weight scaled by
    RRDBNET_GAIN (Kaiming's scale)."""
    return {k: v * RRDBNET_GAIN if k.endswith(".weight") else v
            for k, v in params.items()}
