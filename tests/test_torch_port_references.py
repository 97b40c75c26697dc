"""The recorded JAX references (``tests/golden/port_references/``) against
the JAX package: each case recomputes its record the way
``tests/write_port_references.py`` wrote it, and holds the file to it
(integers and masks equal, floats within 1e-6 of each array's largest
|value|), and its inputs to the record's key. The tier-1 tests that read
the records (``tests/port_references.py`` lists them) rely on this check;
it costs the JAX pipelines' compiles (about 5 min in all), hence
``slow``.
"""

import numpy as np
import pytest

from tests import port_references
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.slow
@pytest.mark.parametrize("name", port_references.NAMES)
def test_record_matches_the_jax_package(name):
    from tests.write_port_references import builders
    key, record = builders()[name]()
    stored = port_references.stored_inputs(name)
    assert key["digest"] == stored["digest"]
    np.testing.assert_allclose(key["fingerprint"], stored["fingerprint"],
                               rtol=1e-6)
    port_references.assert_matches_record(record,
                                          port_references.load(name))


def test_records_stay_small():
    """All six records together under 2 MB."""
    import os
    total = sum(os.path.getsize(port_references.path(n))
                for n in port_references.NAMES)
    assert total < 2 * 1024 * 1024, total
