"""DenseNet against the reference on the CPU (the helper and its
tolerances are in ``test_torch_vision_zoo.py``): its own class with one
layer a dense block and narrow widths (8 stem features, growth 4), the
same code as densenet121-201, at batch 2 and 224 x 224, since its end
pool takes a 7 x 7 map."""
from test_torch_vision_zoo import family_parity


def test_densenet_matches_the_reference():
    family_parity(lambda z: z.DenseNet(8, 4, [1, 1, 1, 1], bn_size=2,
                                       classes=10, prefix="d_"),
                  (2, 3, 224, 224), train=False)
