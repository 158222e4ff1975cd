"""MobileNet v2 against the reference on the CPU (the helper and its
tolerances are in ``test_torch_vision_zoo.py``): the family's own class
at multiplier 0.25, all 17 bottlenecks of mobilenet_v2_1_0 with their
ReLU6 and shortcuts, at batch 2 and 32 x 32."""
from test_torch_vision_zoo import family_parity


def test_mobilenet_v2_matches_the_reference():
    family_parity(lambda z: z.MobileNetV2(0.25, classes=10, prefix="m_"),
                  (2, 3, 32, 32), train=False)
