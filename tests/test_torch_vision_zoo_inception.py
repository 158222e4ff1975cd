"""Inception v3 against the reference on the CPU (the helper and its
tolerances are in ``test_torch_vision_zoo.py``): the whole net at 299 x
299, the least input its end pool (8 x 8) takes, at batch 1 (BatchNorm's
statistics run over the spatial axes). The reference compiles each of
its 94 convolutions' forward and backward: the longest file of the zoo."""
from test_torch_vision_zoo import POOL_TOL, family_parity


def test_inception_v3_matches_the_reference():
    family_parity(lambda z: z.inception_v3(classes=10, prefix="i_"),
                  (1, 3, 299, 299), grad_tol=POOL_TOL, train=False)
