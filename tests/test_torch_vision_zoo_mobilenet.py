"""MobileNet v1 against the reference on the CPU (the helper and its
tolerances are in ``test_torch_vision_zoo.py``): the family's own class
at multiplier 0.25, which keeps every layer of mobilenet1_0, at batch 2
and 32 x 32 (the reference compiles each of its 27 convolutions'
forward and backward)."""
from test_torch_vision_zoo import family_parity


def test_mobilenet_matches_the_reference():
    family_parity(lambda z: z.MobileNet(0.25, classes=10, prefix="m_"),
                  (2, 3, 32, 32), train=False)
