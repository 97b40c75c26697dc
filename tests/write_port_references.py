"""Write the recorded JAX references of the port's heaviest parity tests
(``tests/port_references.py``) into ``tests/golden/port_references/``.

Each record comes from the test module's own ``*jax_reference`` function,
which runs the JAX side exactly as the test ran it before: the same
inputs, keys and injected draws. Run it on the CPU after a change to the
JAX package or to one of these tests' inputs:

    JAX_PLATFORMS=cpu python tests/write_port_references.py [name ...]

(all six records: about 5 min). ``python -m pytest --runslow
tests/test_torch_port_references.py`` checks the records against the
JAX package.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tests.conftest  # noqa: E402,F401  (CPU, 8 virtual devices)
from tests import port_references  # noqa: E402


def builders():
    """name → () → (the inputs' digest, the record)."""
    from tests import (test_torch_geometry, test_torch_learned_features,
                       test_torch_sfm, test_torch_twoview, test_torch_vo)
    return {
        "vo": test_torch_vo.jax_reference,
        "twoview": test_torch_twoview.jax_reference,
        "config2": lambda: test_torch_learned_features.config2_jax_reference(
            test_torch_learned_features.make_params()),
        "sfm": test_torch_sfm.sfm_jax_reference,
        "five_point": test_torch_sfm.five_point_jax_reference,
        "ransac": test_torch_geometry.ransac_jax_reference,
    }


def main(names):
    import torch
    torch.set_num_threads(1)
    build = builders()
    for name in names or port_references.NAMES:
        dig, record = build[name]()
        port_references.save(name, dig, record)
        print(name, os.path.getsize(port_references.path(name)), "bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
