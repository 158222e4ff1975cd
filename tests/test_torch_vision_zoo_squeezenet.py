"""SqueezeNet 1.0 and 1.1 against the reference on the CPU (the helper
and its tolerances are in ``test_torch_vision_zoo.py``), at batch 2 and
224 x 224: the end pool takes a 13 x 13 map."""
import pytest

from test_torch_vision_zoo import POOL_TOL, family_parity


@pytest.mark.parametrize("version", ["1_0", "1_1"])
def test_squeezenet_matches_the_reference(version):
    family_parity(lambda z: getattr(z, "squeezenet" + version)(
        classes=10, prefix="s_"), (2, 3, 224, 224), grad_tol=POOL_TOL)
